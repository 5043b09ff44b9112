// Decode stage 1: a lane's stored and static-Huffman blocks -> tokens.
//
// Replaces: tpu_deflate/kernels/tokenize.py, tokenize_static_batch (Pallas
// bodies _k1_kernel, _k2_kernel, _k3_kernel).  The TPU form decodes a
// candidate symbol at every bit position and recovers the true symbol
// starts by a parallel chase over 64-bit tiles, because the TPU cannot
// step a serial decoder quickly.  Here one thread walks its lane's
// bitstream as a plain DEFLATE decoder.  It also takes stored blocks and
// reports dynamic-tree (ERR_DYNAMIC) and type-3 (ERR_METHOD) blocks, so
// every lane of the indexed container decodes on the card.
//
// Bound on the card: the serial symbol chain.  Each symbol's start depends
// on the previous symbol's width, so a lane costs one dependent step per
// token (~40k for a 64 KiB chunk).  With one lane per block the lanes run
// on separate SMs, each reading its row through its own L1; the card is
// latency-bound and mostly idle, which later work can fix with a parallel
// chase.
//
// Design: the symbol decode is closed-form arithmetic on a 64-bit window
// of the stream (RFC 1951 3.2.6: the static code is piecewise affine in
// its bit-reversed prefix).  The walk reproduces the JAX tokenizer's
// passes of `pwin` bit positions: a pass ends at an end-of-block, a bad
// code, or the first symbol that starts past the window, and its error is
// ERR_OVERFLOW if its tokens do not fit, else ERR_DIST if one reaches
// before the output start, else ERR_BAD_CODE.  A symbol that starts at or
// past the lane's end bit is a bad code.
//
// A lane may also be one whole stream of many blocks: with F_GO_ON an
// end-of-block ends the lane only in a final block (or, with F_ONE_BLOCK,
// in any first block), and the walk goes on through further stored and
// static blocks until a dynamic header stops it with ERR_DYNAMIC at that
// header's bit.  The caller decodes that block elsewhere and resumes the
// walk after it: `resume` gives each lane's bit position, token count and
// output bytes so far, the tokens go on from that slot of the same
// buffers, and distances may reach into all earlier output.  F_LATER says
// that the header at the resume position is not the stream's first, so
// the bounds check that follows only the first header is left out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ERR_OK = 0, ERR_METHOD = 1, ERR_BAD_CODE = 2, ERR_DIST = 4,
              ERR_OVERFLOW = 5, ERR_STORED = 6, ERR_INPUT = 7,
              ERR_DYNAMIC = 8;
constexpr int TK_LIT = 0, TK_MATCH = 1, TK_STORED = 2;
constexpr int M_HEADER = 0, M_TOKENS = 3, M_DONE = 4, M_ERROR = 5;
constexpr int K_LIT = 0, K_EOB = 1, K_MATCH = 2, K_BAD = 3;
constexpr int F_GO_ON = 1, F_ONE_BLOCK = 2, F_LATER = 4;

// The stream's bits from bit position pos on, LSB first; bytes past the
// row read as zero.  At least 57 bits are valid.
__device__ __forceinline__ uint64_t bits_at(const uint8_t* row, int M,
                                            long long pos) {
  const long long b0 = pos >> 3;
  uint64_t w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long j = b0 + k;
    const uint64_t v = (j < M) ? __ldg(row + j) : 0;
    w |= v << (8 * k);
  }
  return w >> (pos & 7);
}

struct Sym {
  int kind, adv, ta, dist;
};

__device__ __forceinline__ Sym static_symbol(uint64_t w) {
  Sym s;
  const int v9 = __brev((unsigned)(w & 0x1FF)) >> 23;  // MSB-first prefix
  const int c7 = v9 >> 2, c8 = v9 >> 1;
  int nb, sym;
  if (c7 < 24) {              // 7 bits: 256..279
    nb = 7;
    sym = 256 + c7;
  } else if (c8 >= 48 && c8 < 200) {  // 8 bits: 0..143, 280..287
    nb = 8;
    sym = c8 < 192 ? c8 - 48 : 280 + (c8 - 192);
  } else {                    // 9 bits: 144..255
    nb = 9;
    sym = 144 + (v9 - 400);
  }
  if (sym > 285) {
    s.kind = K_BAD;
    s.adv = 1;
    s.ta = s.dist = 0;
    return s;
  }
  if (sym < 256) {
    s.kind = K_LIT;
    s.adv = nb;
    s.ta = sym;
    s.dist = 0;
    return s;
  }
  if (sym == 256) {
    s.kind = K_EOB;
    s.adv = nb;
    s.ta = s.dist = 0;
    return s;
  }
  const int i = sym - 257;
  const int ebits = (i < 8 || i == 28) ? 0 : (i >> 2) - 1;
  const int lbase = i == 28 ? 258 : (i < 8 ? i + 3 : ((4 + (i & 3)) << ebits) + 3);
  const int length = lbase + (int)((w >> nb) & ((1u << ebits) - 1));
  const int doff = nb + ebits;
  const int dsym = __brev((unsigned)((w >> doff) & 31)) >> 27;
  if (dsym > 29) {
    s.kind = K_BAD;
    s.adv = 1;
    s.ta = s.dist = 0;
    return s;
  }
  const int debits = dsym < 2 ? 0 : (dsym >> 1) - 1;
  const int dbase = dsym < 2 ? dsym + 1 : ((2 + (dsym & 1)) << debits) + 1;
  s.kind = K_MATCH;
  s.adv = doff + 5 + debits;
  s.ta = length;
  s.dist = dbase + (int)((w >> (doff + 5)) & ((1u << debits) - 1));
  return s;
}

// kStream: the lane is a whole stream (flags and resume are read); without
// it they are compiled out, and the lane stops at its first end-of-block.
template <bool kStream>
__global__ void tokenize_static_kernel(
    const uint8_t* __restrict__ rows, const int* __restrict__ end_bits,
    int* __restrict__ tk, int* __restrict__ ta, int* __restrict__ tb,
    int* __restrict__ ntok_out, int* __restrict__ total_out,
    int* __restrict__ pos_out, int* __restrict__ err_out,
    const int* __restrict__ resume, int flags, int B, int M, int tok_cap,
    int pwin) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const uint8_t* row = rows + (size_t)lane * M;
  int* tkl = tk + (size_t)lane * tok_cap;
  int* tal = ta + (size_t)lane * tok_cap;
  int* tbl = tb + (size_t)lane * tok_cap;
  const long long end = end_bits[lane];
  const long long nbits = 8LL * M;

  if (!kStream) {
    resume = nullptr;
    flags = 0;
  }
  long long pos = resume ? resume[3 * lane] : 0;
  int tp = resume ? resume[3 * lane + 1] : 0;
  int total = resume ? resume[3 * lane + 2] : 0;
  int mode = M_HEADER, err = ERR_OK, bfinal = 0;
  // what ends the lane: any end-of-block, any block, or a final block
  const bool eob_ends = !(flags & F_GO_ON) || (flags & F_ONE_BLOCK);
  const bool stored_ends = (flags & F_ONE_BLOCK) != 0;

  auto in_bounds = [&]() {
    return pos <= nbits && pos < end && tp < tok_cap - 1;
  };

  auto header = [&]() {
    const uint64_t w = bits_at(row, M, pos);
    bfinal = (int)(w & 1);
    const int btype = (int)((w >> 1) & 3);
    if (btype == 0) {
      const long long p = (pos + 3 + 7) & ~7LL;
      const uint64_t ws = bits_at(row, M, p);
      const int len = (int)(ws & 0xFFFF);
      const bool ok = len == (int)(((ws >> 16) & 0xFFFF) ^ 0xFFFF);
      tkl[tp] = TK_STORED;  // tp < tok_cap - 1 here
      tal[tp] = len;
      tbl[tp] = (int)((p + 32) >> 3);
      ++tp;
      total += len;
      pos = p + 32 + 8LL * len;
      mode = !ok ? M_ERROR : (bfinal || stored_ends ? M_DONE : M_HEADER);
      if (!ok) err = ERR_STORED;
    } else if (btype == 1) {
      pos += 3;
      mode = M_TOKENS;
    } else {
      mode = M_ERROR;
      err = btype == 2 ? ERR_DYNAMIC : ERR_METHOD;
    }
  };

  auto block_pass = [&]() {
    const long long base = pos;
    long long p = base, next_pos;
    int n = 0, produced = 0;
    bool too_far = false, bad = false, eob = false;
    while (true) {
      if (p - base >= pwin) {  // the chain leaves the pass's window
        next_pos = p;
        break;
      }
      const Sym s = p >= end ? Sym{K_BAD, 1, 0, 0}
                             : static_symbol(bits_at(row, M, p));
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
    }
    const bool cap_ok = tp + n < tok_cap - 1;
    if (cap_ok) {
      tp += n;
      total += produced;
    }
    pos = next_pos;
    too_far = too_far && cap_ok;
    if (bad || too_far || !cap_ok) {
      mode = M_ERROR;
      err = too_far ? ERR_DIST : (!cap_ok ? ERR_OVERFLOW : ERR_BAD_CODE);
    } else {
      mode = !eob ? M_TOKENS : (eob_ends || bfinal ? M_DONE : M_HEADER);
    }
  };

  if (!(flags & F_LATER) && mode < M_DONE && in_bounds()) header();
  while (mode < M_DONE && in_bounds()) {
    if (mode == M_HEADER) header();
    if (mode == M_TOKENS) block_pass();
  }
  const bool clean =
      mode == M_DONE || (err == ERR_OK && pos >= end && mode == M_HEADER);
  if (!clean && err == ERR_OK) {
    err = tp >= tok_cap - 1 ? ERR_OVERFLOW : ERR_INPUT;
  }
  ntok_out[lane] = tp;
  total_out[lane] = total;
  pos_out[lane] = (int)pos;
  err_out[lane] = err;
}

}  // namespace

extern "C" int tokenize_static_launch(const void* rows, const void* end_bits,
                                      void* tk, void* ta, void* tb,
                                      void* ntok, void* total, void* pos,
                                      void* err, const void* resume,
                                      int flags, int B, int M, int tok_cap,
                                      int pwin, void* stream) {
  // one lane per block: the lanes spread over the SMs and their L1 caches
  auto kernel = (resume || flags) ? tokenize_static_kernel<true>
                                   : tokenize_static_kernel<false>;
  kernel<<<B, 1, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const int*)end_bits, (int*)tk, (int*)ta,
      (int*)tb, (int*)ntok, (int*)total, (int*)pos, (int*)err,
      (const int*)resume, flags, B, M, tok_cap, pwin);
  return (int)cudaGetLastError();
}
