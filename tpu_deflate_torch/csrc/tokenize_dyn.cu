// Decode stage 1: one static- or dynamic-tree block per lane -> tokens,
// from the lane's packed code tables, one thread block a lane.
//
// Replaces: tpu_deflate/kernels/tokenize_dyn.py, tokenize_dyn_batch (Pallas
// bodies _k1d_kernel, _k2d_kernel, _k3d_kernel).  The TPU form decodes a
// candidate symbol at every bit position under the lane's tables, chases
// the true symbol starts across 64-bit tiles, and compacts the tokens with
// one-hot MXU products, because the TPU cannot walk a pointer chain
// quickly.
//
// Bound on the card: bytes.  A pass reads its window once from device
// memory and writes each token once; the symbol decodes run from shared
// memory, spread over a block of 1024 threads.  A walk of the lane by one
// thread (the form this kernel replaced) was bound instead by its chain of
// dependent symbol decodes, one per token, at about 384 ns a token.
//
// Design: the pass engine of pass.cuh (its head note), the one the static
// kernel runs, under the lane's own tables.  The block unpacks the lane's
// table (layout TAB_* in kernels/tokenize_dyn.py) into shared memory, then
// builds two first-level tables from it: 1024 entries on the first 10
// bits of a literal/length code and 512 on the first 9 of a distance code,
// each holding the symbol's kind, code width, extra bits and base where
// the code is that short.  A longer code is decoded by counting the 15
// limits its prefix does not undercut (dyn_sym.cuh).  The passes are the
// JAX tokenizer's, of `pwin` bit positions.  A dynamic symbol can be 48
// bits wide (a 15-bit code, 5 extra bits, a 15-bit distance code, 13 extra
// bits), so the subsequences are S >= 64 bits, and a symbol is read from
// 64 bits of the window, taken with two funnel shifts.
// Where the static kernel keeps a walk's tokens in the thread's slice, this
// one keeps their 16-bit bit offsets in the subsequence, and the warp that
// copies a slot decodes its symbol again: a literal/length code can be 1
// bit wide, so a subsequence may hold S tokens, and whole tokens would not
// fit in shared memory.  A slice holds as many offsets as shared memory
// allows (`slice_words`, from the launcher); a walk with more tokens than
// that walks again after the pass is cut and writes its tokens straight
// into their slots (the engine's step 4).
//
// The lane's state is the serial walk's and the JAX tokenizer's.  The
// first pass follows the header at once, later ones only while the lane
// is in bounds.  A lane whose status is >= 0 ended in its header: it
// reports that code, no new tokens, and its start as its end bit.  A block
// that follows earlier blocks of its lane starts its count at tok0 tokens
// and the table's TAB_OUTBASE output bytes: its tokens go to the slots
// from tok0 on, and its matches may reach into that output.  With `fresh`
// the kernel also zeroes each lane's slots outside the block's tokens, so
// the buffers need no memset; without it (the caller's buffers) it writes
// only the block's tokens.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dyn_sym.cuh"
#include "launch.cuh"
#include "pass.cuh"

namespace {

using namespace dyn;
using pass::kThreads;
using pass::window_chunks;

constexpr int MIN_SUB = 64;  // a symbol is at most 48 bits wide
constexpr int LIT_BITS = 10, DIST_BITS = 9;  // the first-level tables

// The first-level tables of the lane's codes.  lut[first 10 bits, LSB
// first] = kind | width << 2 | extra bits << 6 | (literal or length base)
// << 9, and dlut[first 9 bits] = bad | width << 1 | extra bits << 5 | base
// << 9; width 0 where the code is longer (or the prefix alone does not
// decide it).  A prefix decides a code of width nb <= 10 when its shortest
// and longest 15-bit extensions give the same width: the width does not
// fall as the prefix grows, and the rank depends on the first nb bits.
__device__ void fill_luts(const Tables& t, uint32_t* lut, uint32_t* dlut) {
  for (int r = threadIdx.x; r < (1 << LIT_BITS); r += blockDim.x) {
    const int vmin = (int)(__brev((unsigned)r) >> 17);
    const int nb = code_len(vmin, t.lim[0]);
    uint32_t e = 0;
    if (nb <= LIT_BITS &&
        code_len(vmin | ((1 << (15 - LIT_BITS)) - 1), t.lim[0]) == nb) {
      const int rank = (vmin >> (15 - nb)) + t.rd[0][nb];
      const int symp1 = rank >= 0 && rank < 288 ? t.lit_sym[rank] : 0;
      const int sym = symp1 - 1;
      if (symp1 == 0 || sym > 285) {
        e = K_BAD | 1u << 2;
      } else if (sym < 256) {
        e = K_LIT | nb << 2 | (uint32_t)sym << 9;
      } else if (sym == 256) {
        e = K_EOB | nb << 2;
      } else {
        const int i = sym - 257;
        const int ebits = (i < 8 || i == 28) ? 0 : (i >> 2) - 1;
        const int lbase =
            i == 28 ? 258 : (i < 8 ? i + 3 : ((4 + (i & 3)) << ebits) + 3);
        e = K_MATCH | nb << 2 | ebits << 6 | (uint32_t)lbase << 9;
      }
    }
    lut[r] = e;
  }
  for (int r = threadIdx.x; r < (1 << DIST_BITS); r += blockDim.x) {
    const int vmin = (int)(__brev((unsigned)r) >> 17);
    const int nb = code_len(vmin, t.lim[1]);
    uint32_t e = 0;
    if (nb <= DIST_BITS &&
        code_len(vmin | ((1 << (15 - DIST_BITS)) - 1), t.lim[1]) == nb) {
      const int rank = (vmin >> (15 - nb)) + t.rd[1][nb];
      const int symp1 = rank >= 0 && rank < 32 ? t.dist_sym[rank] : 0;
      if (symp1 == 0) {
        e = 1u | 1u << 1;
      } else {
        const int dsym = symp1 - 1 > 29 ? 29 : symp1 - 1;
        const int debits = dsym < 2 ? 0 : (dsym >> 1) - 1;
        const int dbase =
            dsym < 2 ? dsym + 1 : ((2 + (dsym & 1)) << debits) + 1;
        e = (uint32_t)(nb << 1 | debits << 5) | (uint32_t)dbase << 9;
      }
    }
    dlut[r] = e;
  }
}

// A symbol with a code longer than the first-level tables take: by the
// limits.  Out of line, so the walk's loop stays small.
__device__ __noinline__ Sym slow_symbol(uint64_t w, const Tables* t) {
  return dyn_symbol(w, t->lim[0], t->rd[0], t->lit_sym, t->lim[1], t->rd[1],
                    t->dist_sym);
}

// One pass's window in shared memory: `win` holds the stream from a
// 16-byte-aligned address on, and position `base` of the lane is bit `off`
// of it.  Positions at or past `room` (end - base) are bad codes.
struct Window {
  const uint32_t* win;
  const uint32_t *lut, *dlut;
  const Tables* tabs;
  int off, room;

  // the symbol at position p, from 64 bits of the window
  __device__ __forceinline__ Sym at(int p) const {
    if (p >= room) return Sym{K_BAD, 1, 0, 0};
    const int q = off + p;
    const uint32_t* x = win + (q >> 5);
    const uint32_t lo = __funnelshift_r(x[0], x[1], q);
    const uint32_t hi = __funnelshift_r(x[1], x[2], q);
    const uint64_t w = (uint64_t)hi << 32 | lo;
    const uint32_t e = lut[lo & ((1 << LIT_BITS) - 1)];
    const int nb = (e >> 2) & 15;
    if (nb == 0) return slow_symbol(w, tabs);
    const int kind = e & 3;
    if (kind != K_MATCH) {
      return Sym{kind, kind == K_BAD ? 1 : nb, kind == K_LIT ? (int)(e >> 9) : 0, 0};
    }
    const int eb = (e >> 6) & 7;
    const int length = (int)(e >> 9) + (int)((lo >> nb) & ((1u << eb) - 1));
    const int doff = nb + eb;
    const uint64_t wd = w >> doff;
    const uint32_t d = dlut[(uint32_t)wd & ((1 << DIST_BITS) - 1)];
    const int dnb = (d >> 1) & 15;
    if (dnb == 0) return slow_symbol(w, tabs);
    if (d & 1) return Sym{K_BAD, 1, 0, 0};
    const int deb = (d >> 5) & 15;
    return Sym{K_MATCH, doff + dnb + deb, length,
               (int)(d >> 9) + (int)((uint32_t)(wd >> dnb) & ((1u << deb) - 1))};
  }
};

// The pass engine's policy (pass.cuh): a slice keeps its walk's tokens'
// bit offsets in the subsequence, and a token is decoded again from its
// offset at copy-out.
struct Offsets {
  static constexpr int kMinSub = MIN_SUB;
  uint16_t* offs;
  int cap;
  const uint32_t *lut, *dlut;
  const Tables* tabs;

  __device__ __forceinline__ Window window(const uint32_t* win, int off,
                                           int room) const {
    return Window{win, lut, dlut, tabs, off, room};
  }
  __device__ __forceinline__ void keep(int k, int d, const Sym&) {
    if (k < cap) offs[threadIdx.x * cap + k] = (uint16_t)d;
  }
  __device__ __forceinline__ Sym token(const Window& w, int o, int lo,
                                       int k) const {
    return w.at(lo + offs[o * cap + k]);
  }
};

__global__ void __launch_bounds__(kThreads) tokenize_dyn_kernel(
    const uint8_t* __restrict__ rows, const int* __restrict__ end_bits,
    const int* __restrict__ tab, const int* __restrict__ starts,
    const int* __restrict__ status, const int* __restrict__ tok0,
    int* __restrict__ tk, int* __restrict__ ta, int* __restrict__ tb,
    int* __restrict__ ntok_out, int* __restrict__ total_out,
    int* __restrict__ pos_out, int* __restrict__ err_out, int fresh, int M,
    int tok_cap, int pwin, int slice_words) {
  extern __shared__ uint4 win4[];  // the window, then the offset slices
  __shared__ pass::Shared sh;
  __shared__ Tables tabs;
  __shared__ uint32_t lut[1 << LIT_BITS], dlut[1 << DIST_BITS];

  const int lane = blockIdx.x;
  const uint8_t* row = rows + (size_t)lane * M;
  const pass::Slots out{tk + (size_t)lane * tok_cap,
                        ta + (size_t)lane * tok_cap,
                        tb + (size_t)lane * tok_cap};
  const int* t = tab + (size_t)lane * TAB_W;
  const long long end = end_bits[lane];
  const long long nbits = 8LL * M;
  const int code = status[lane], first_tok = tok0[lane];

  // the lane's state: every thread holds the same copy
  pass::Lane st{starts[lane], first_tok, t[TAB_OUTBASE]};
  int err = code >= 0 ? code : ERR_OK;

  if (code < 0) {  // uniform over the block
    load_tables(tabs, t);
    __syncthreads();
    fill_luts(tabs, lut, dlut);  // read after the first pass's barriers
    Offsets pol{(uint16_t*)(win4 + window_chunks(pwin)), 2 * slice_words,
                lut, dlut, &tabs};
    bool done = false, failed = false, first = true;
    while (!done && !failed && (first || st.in_bounds(nbits, end, tok_cap))) {
      first = false;
      bool eob;
      const int e = pass::run_pass(pol, sh, win4, row, M, end, pwin, tok_cap,
                                   out, st, eob);
      if (e != ERR_OK) {
        failed = true;
        err = e;
      } else {
        done = eob;
      }
    }
    if (!done && err == ERR_OK) {
      err = st.tp >= tok_cap - 1 ? ERR_OVERFLOW : ERR_INPUT;
    }
  }
  if (fresh) {  // fresh buffers: zero the slots outside the block's tokens
    out.zero(0, first_tok < tok_cap ? first_tok : tok_cap);
    out.zero(st.tp, tok_cap);
  }
  if (threadIdx.x == 0) {
    ntok_out[lane] = st.tp;
    total_out[lane] = st.total;
    pos_out[lane] = (int)st.pos;
    err_out[lane] = err;
  }
}

}  // namespace

extern "C" int tokenize_dyn_launch(const void* rows, const void* end_bits,
                                   const void* tab, const void* starts,
                                   const void* status, const void* tok0,
                                   void* tk, void* ta, void* tb, void* ntok,
                                   void* total, void* pos, void* err,
                                   int fresh, int B, int M, int tok_cap,
                                   int pwin, void* stream) {
  // one block of kThreads a lane; the window and the offset slices take
  // dynamic shared memory, the slices as much as the block may still use
  // (at most S offsets a thread, which no walk exceeds)
  static launch::DynSmem limit;
  const long long room = limit.limit(tokenize_dyn_kernel);
  if (room < 0) return (int)(-room);
  const long long window = 16LL * window_chunks(pwin);
  const int most = (pass::sub_bits(pwin, MIN_SUB) + 1) / 2;
  int words = (int)((room - window) / (4 * kThreads));
  words = words < most ? words : most;
  if (words > 1 && words % 2 == 0) --words;  // odd: a warp's slices in
                                             // different banks
  if (words < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)window + 4 * (size_t)kThreads * words;
  tokenize_dyn_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const int*)end_bits, (const int*)tab,
      (const int*)starts, (const int*)status, (const int*)tok0, (int*)tk,
      (int*)ta, (int*)tb, (int*)ntok, (int*)total, (int*)pos, (int*)err,
      fresh, M, tok_cap, pwin, words);
  return (int)cudaGetLastError();
}
