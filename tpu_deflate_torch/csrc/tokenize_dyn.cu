// Decode stage 1: one static- or dynamic-tree block per lane -> tokens,
// from the lane's packed code tables.
//
// Replaces: tpu_deflate/kernels/tokenize_dyn.py, tokenize_dyn_batch (Pallas
// bodies _k1d_kernel, _k2d_kernel, _k3d_kernel).  The TPU form decodes a
// candidate symbol at every bit position under the lane's tables, chases
// the true symbol starts across 64-bit tiles, and compacts the tokens with
// one-hot MXU products, because the TPU cannot walk a pointer chain
// quickly.  Here one thread walks its lane's bitstream as a plain DEFLATE
// decoder.
//
// Bound on the card: the serial symbol chain, as in tokenize.cu.  Each
// symbol's start depends on the previous symbol's width, so a lane costs
// one dependent step per token; the lanes run one per block, on separate
// SMs.
//
// Design: the block's threads unpack the lane's table (layout TAB_* in
// kernels/tokenize_dyn.py) into shared memory: rank -> symbol for the
// literal/length and distance codes.  Thread 0 then walks.  A code's
// length is the number of limits lim[1..15] that its 15-bit MSB-first
// prefix does not undercut, plus one (the limits held in registers), its
// rank the prefix's top bits plus rd[length].  The stream is read through
// a 64-bit bit buffer refilled a byte at a time, since the walk only moves
// forward.  The walk reproduces the JAX tokenizer's passes of `pwin` bit
// positions: a pass ends at an end-of-block, a bad code, or the first
// symbol that starts past the window, and its error is ERR_OVERFLOW if its
// tokens do not fit, else ERR_DIST if one reaches before the output
// start, else ERR_BAD_CODE.  A symbol that starts at or past the lane's
// end bit is a bad code.  A lane whose status is >= 0 ended in its header:
// it reports that code, no new tokens, and its start as its end bit.  A
// block that follows earlier blocks of its lane starts its count at tok0
// tokens and the table's TAB_OUTBASE output bytes: its tokens go to the
// slots from tok0 on, and its matches may reach into that output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dyn_sym.cuh"

namespace {

using namespace dyn;

// The stream from the walker's bit position on, LSB first; bytes past the
// row read as zero.  After fill(), at least 57 bits are valid.
struct BitReader {
  const uint8_t* row;
  long long M, next_byte;
  uint64_t buf;
  int cnt;

  __device__ void init(const uint8_t* r, long long m, long long pos) {
    row = r;
    M = m;
    next_byte = pos >> 3;
    buf = 0;
    cnt = 0;
    fill();
    buf >>= (pos & 7);
    cnt -= (int)(pos & 7);
  }
  __device__ __forceinline__ void fill() {
    while (cnt <= 56) {
      const uint64_t v =
          (next_byte >= 0 && next_byte < M) ? __ldg(row + next_byte) : 0;
      buf |= v << cnt;
      ++next_byte;
      cnt += 8;
    }
  }
  __device__ __forceinline__ void skip(int n) {  // n <= 48
    buf >>= n;
    cnt -= n;
  }
};

__global__ void tokenize_dyn_kernel(
    const uint8_t* __restrict__ rows, const int* __restrict__ end_bits,
    const int* __restrict__ tab, const int* __restrict__ starts,
    const int* __restrict__ status, const int* __restrict__ tok0,
    int* __restrict__ tk, int* __restrict__ ta, int* __restrict__ tb,
    int* __restrict__ ntok_out,
    int* __restrict__ total_out, int* __restrict__ pos_out,
    int* __restrict__ err_out, int M, int tok_cap, int pwin) {
  const int lane = blockIdx.x;
  const int* t = tab + (size_t)lane * TAB_W;
  __shared__ Tables tabs;
  load_tables(tabs, t);
  __syncthreads();
  if (threadIdx.x != 0) return;

  const long long start = starts[lane];
  if (status[lane] >= 0) {  // the lane ended in its header
    ntok_out[lane] = tok0[lane];
    total_out[lane] = t[TAB_OUTBASE];
    pos_out[lane] = (int)start;
    err_out[lane] = status[lane];
    return;
  }
  int lit_lim[16], dist_lim[16];
#pragma unroll
  for (int L = 0; L < 16; ++L) {
    lit_lim[L] = tabs.lim[0][L];
    dist_lim[L] = tabs.lim[1][L];
  }
  const uint8_t* row = rows + (size_t)lane * M;
  int* tkl = tk + (size_t)lane * tok_cap;
  int* tal = ta + (size_t)lane * tok_cap;
  int* tbl = tb + (size_t)lane * tok_cap;
  const long long end = end_bits[lane];
  const long long nbits = 8LL * M;

  BitReader rd;
  rd.init(row, M, start);
  long long pos = start;
  int tp = tok0[lane], total = t[TAB_OUTBASE], err = ERR_OK;
  bool done = false, failed = false, first = true;

  // the first pass follows the header at once, as in the JAX block loop
  while (!done && !failed &&
         (first || (pos <= nbits && pos < end && tp < tok_cap - 1))) {
    first = false;
    const long long base = pos;
    long long p = base, next_pos;
    int n = 0, produced = 0;
    bool too_far = false, bad = false, eob = false;
    while (true) {
      if (p - base >= pwin) {  // the chain leaves the pass's window
        next_pos = p;
        break;
      }
      Sym s{K_BAD, 1, 0, 0};
      if (p < end) {
        rd.fill();
        s = dyn_symbol(rd.buf, lit_lim, tabs.rd[0], tabs.lit_sym, dist_lim,
                       tabs.rd[1], tabs.dist_sym);
      }
      if (s.kind == K_BAD) {
        bad = true;
        next_pos = p + 1;
        break;
      }
      if (s.kind == K_EOB) {
        eob = true;
        next_pos = p + s.adv;
        break;
      }
      if (s.kind == K_MATCH && s.dist > total + produced) too_far = true;
      const int slot = tp + n;
      if (slot < tok_cap) {
        tkl[slot] = s.kind == K_MATCH ? TK_MATCH : TK_LIT;
        tal[slot] = s.ta;
        tbl[slot] = s.dist;
      }
      produced += s.kind == K_LIT ? 1 : s.ta;
      ++n;
      p += s.adv;
      rd.skip(s.adv);
    }
    const bool cap_ok = tp + n < tok_cap - 1;
    if (cap_ok) {
      tp += n;
      total += produced;
    } else {
      for (int k = tp; k < tok_cap && k < tp + n; ++k) {  // nothing kept
        tkl[k] = tal[k] = tbl[k] = 0;
      }
    }
    pos = next_pos;
    too_far = too_far && cap_ok;
    if (bad || too_far || !cap_ok) {
      failed = true;
      err = too_far ? ERR_DIST : (!cap_ok ? ERR_OVERFLOW : ERR_BAD_CODE);
    } else {
      done = eob;
    }
  }
  if (!done && err == ERR_OK) {
    err = tp >= tok_cap - 1 ? ERR_OVERFLOW : ERR_INPUT;
  }
  ntok_out[lane] = tp;
  total_out[lane] = total;
  pos_out[lane] = (int)pos;
  err_out[lane] = err;
}

}  // namespace

extern "C" int tokenize_dyn_launch(const void* rows, const void* end_bits,
                                   const void* tab, const void* starts,
                                   const void* status, const void* tok0,
                                   void* tk, void* ta, void* tb, void* ntok,
                                   void* total, void* pos, void* err, int B,
                                   int M, int tok_cap, int pwin,
                                   void* stream) {
  // one lane per block: its threads unpack the tables, thread 0 walks
  tokenize_dyn_kernel<<<B, 64, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const int*)end_bits, (const int*)tab,
      (const int*)starts, (const int*)status, (const int*)tok0, (int*)tk,
      (int*)ta, (int*)tb, (int*)ntok, (int*)total, (int*)pos, (int*)err, M,
      tok_cap, pwin);
  return (int)cudaGetLastError();
}
