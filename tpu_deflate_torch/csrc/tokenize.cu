// Decode stage 1: a lane's stored and static-Huffman blocks -> tokens.
//
// Replaces: tpu_deflate/kernels/tokenize.py, tokenize_static_batch (Pallas
// bodies _k1_kernel, _k2_kernel, _k3_kernel).  Like the TPU form, a pass
// decodes candidate symbols at any bit position and recovers the true
// symbol starts in parallel, instead of stepping one symbol at a time.  It
// also takes stored blocks and reports dynamic-tree (ERR_DYNAMIC) and
// type-3 (ERR_METHOD) blocks, so every lane of the indexed container
// decodes on the card.
//
// Bound on the card: bytes.  A pass reads its window once from device
// memory and writes each token once; the symbol decodes run from shared
// memory, spread over a block of 1024 threads, so no chain of dependent
// steps as long as the lane is left.
//
// Design: one thread block a lane, the block loop as the JAX tokenizer
// runs it, each Huffman block in passes of `pwin` bit positions by the
// pass engine of pass.cuh (its head note): the window staged with
// cp.async, the symbol starts found by a fixed-point iteration over
// subsequences of S >= 32 bits (a static symbol is at most 31 bits wide),
// a block-minimum cut, block scans, and a warp-at-a-time copy-out only
// where the pass's tokens fit.  A walk keeps the tokens it passes before
// its first terminal, packed, in the thread's own slice of shared memory:
// a token is at least 8 bits wide, so a slice of S / 8 + 1 holds them all.
// Block headers are decoded by every thread alike (one thread writes a
// stored block's token), so the lane's state needs no shared copy.  A
// symbol is two table reads in shared memory (512 entries for the
// literal/length code by its first 9 bits, 32 for the distance code),
// filled from the closed form of RFC 1951 3.2.6, on 32 bits of the window
// taken with one funnel shift.  Without `resume` the kernel also zeroes
// each lane's token slots from its count on, so the buffers need no memset.
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

#include "launch.cuh"
#include "pass.cuh"

namespace {

using namespace pass;

constexpr int ERR_METHOD = 1, ERR_STORED = 6, ERR_DYNAMIC = 8;
constexpr int TK_STORED = 2;
constexpr int M_HEADER = 0, M_TOKENS = 3, M_DONE = 4, M_ERROR = 5;
constexpr int F_GO_ON = 1, F_ONE_BLOCK = 2, F_LATER = 4;

constexpr int MIN_SUB = 32;  // a symbol is at most 31 bits wide

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

// The static code as two tables: lit[first 9 bits, LSB first] = kind |
// width << 2 | extra bits << 6 | (literal or length base) << 9, and
// dist[5 bits] = bad | extra bits << 1 | base << 5.  The literal/length
// code is piecewise affine in its bit-reversed prefix.
__device__ void fill_tables(uint32_t* lit, uint32_t* dist) {
  for (int r = threadIdx.x; r < 512; r += blockDim.x) {
    const int v9 = __brev((unsigned)r) >> 23;  // MSB-first prefix
    const int c7 = v9 >> 2, c8 = v9 >> 1;
    int nb, sym;
    if (c7 < 24) {  // 7 bits: 256..279
      nb = 7;
      sym = 256 + c7;
    } else if (c8 >= 48 && c8 < 200) {  // 8 bits: 0..143, 280..287
      nb = 8;
      sym = c8 < 192 ? c8 - 48 : 280 + (c8 - 192);
    } else {  // 9 bits: 144..255
      nb = 9;
      sym = 144 + (v9 - 400);
    }
    uint32_t e;
    if (sym > 285) {
      e = K_BAD;
    } else if (sym < 256) {
      e = K_LIT | nb << 2 | (uint32_t)sym << 9;
    } else if (sym == 256) {
      e = K_EOB | nb << 2;
    } else {
      const int i = sym - 257;
      const int ebits = (i < 8 || i == 28) ? 0 : (i >> 2) - 1;
      const int base = i == 28 ? 258 : (i < 8 ? i + 3 : ((4 + (i & 3)) << ebits) + 3);
      e = K_MATCH | nb << 2 | ebits << 6 | (uint32_t)base << 9;
    }
    lit[r] = e;
  }
  for (int r = threadIdx.x; r < 32; r += blockDim.x) {
    const int dsym = __brev((unsigned)r) >> 27;
    const int debits = dsym < 2 ? 0 : (dsym >> 1) - 1;
    const int base = dsym < 2 ? dsym + 1 : ((2 + (dsym & 1)) << debits) + 1;
    dist[r] = dsym > 29 ? 1u : (uint32_t)(debits << 1 | base << 5);
  }
}

// One pass's window in shared memory: `win` holds the stream from a
// 16-byte-aligned address on, and position `base` of the lane is bit `off`
// of it.  Positions at or past `room` (end - base) are bad codes.
struct Window {
  const uint32_t* win;
  const uint32_t *lit, *dist;
  int off, room;

  // the symbol at position p, from 32 bits of the window (a symbol is at
  // most 31 bits wide)
  __device__ __forceinline__ Sym at(int p) const {
    if (p >= room) return Sym{K_BAD, 1, 0, 0};
    const int q = off + p;
    const uint32_t w = __funnelshift_r(win[q >> 5], win[(q >> 5) + 1], q);
    const uint32_t e = lit[w & 511];
    const int kind = e & 3, nb = (e >> 2) & 15;
    if (kind != K_MATCH) {
      return Sym{kind, kind == K_BAD ? 1 : nb, kind == K_LIT ? (int)(e >> 9) : 0, 0};
    }
    const int eb = (e >> 6) & 7;
    const int length = (int)(e >> 9) + (int)((w >> nb) & ((1u << eb) - 1));
    const int doff = nb + eb;
    const uint32_t d = dist[(w >> doff) & 31];
    if (d & 1) return Sym{K_BAD, 1, 0, 0};
    const int deb = (d >> 1) & 15;
    return Sym{K_MATCH, doff + 5 + deb, length,
               (int)(d >> 5) + (int)((w >> (doff + 5)) & ((1u << deb) - 1))};
  }
};

// Words of a thread's token slice: a token is at least 8 bits wide, so
// S / 8 + 1 (odd, so the threads of a warp write their slices in
// different banks).
__host__ __device__ __forceinline__ int slice_words(int pwin) {
  return ((sub_bits(pwin, MIN_SUB) + 7) / 8 + 1) | 1;
}

// The pass engine's policy (pass.cuh): a slice keeps its walk's tokens
// packed, match << 25 | length or literal << 16 | distance.
struct Packed {
  static constexpr int kMinSub = MIN_SUB;
  uint32_t* toks;
  int cap;
  const uint32_t *lit, *dist;

  __device__ __forceinline__ Window window(const uint32_t* win, int off,
                                           int room) const {
    return Window{win, lit, dist, off, room};
  }
  __device__ __forceinline__ void keep(int k, int, const Sym& y) {
    if (k < cap) {
      toks[threadIdx.x * cap + k] = (uint32_t)(y.kind == K_MATCH) << 25 |
                                    (uint32_t)y.ta << 16 | (uint32_t)y.dist;
    }
  }
  __device__ __forceinline__ Sym token(const Window&, int o, int,
                                       int k) const {
    const uint32_t t = toks[o * cap + k];
    return Sym{t >> 25 ? K_MATCH : K_LIT, 0, (int)((t >> 16) & 511),
               (int)(t & 0xFFFF)};
  }
};

// kStream: the lane is a whole stream (flags and resume are read); without
// it they are compiled out, and the lane stops at its first end-of-block.
template <bool kStream>
__global__ void __launch_bounds__(kThreads) tokenize_static_kernel(
    const uint8_t* __restrict__ rows, const int* __restrict__ end_bits,
    int* __restrict__ tk, int* __restrict__ ta, int* __restrict__ tb,
    int* __restrict__ ntok_out, int* __restrict__ total_out,
    int* __restrict__ pos_out, int* __restrict__ err_out,
    const int* __restrict__ resume, int flags, int M, int tok_cap, int pwin) {
  extern __shared__ uint4 win4[];  // the window, then the token slices
  __shared__ Shared sh;
  __shared__ uint32_t lit_tab[512], dist_tab[32];

  const int lane = blockIdx.x;
  const uint8_t* row = rows + (size_t)lane * M;
  const Slots out{tk + (size_t)lane * tok_cap, ta + (size_t)lane * tok_cap,
                  tb + (size_t)lane * tok_cap};
  const long long end = end_bits[lane];
  const long long nbits = 8LL * M;

  if (!kStream) {
    resume = nullptr;
    flags = 0;
  }
  // the lane's state: every thread holds the same copy
  Lane st{resume ? resume[3 * lane] : 0, resume ? resume[3 * lane + 1] : 0,
          resume ? resume[3 * lane + 2] : 0};
  int mode = M_HEADER, err = ERR_OK, bfinal = 0;
  // what ends the lane: any end-of-block, any block, or a final block
  const bool eob_ends = !(flags & F_GO_ON) || (flags & F_ONE_BLOCK);
  const bool stored_ends = (flags & F_ONE_BLOCK) != 0;

  Packed pol{(uint32_t*)(win4 + window_chunks(pwin)), slice_words(pwin),
             lit_tab, dist_tab};
  fill_tables(lit_tab, dist_tab);  // read after the first pass's barriers

  auto header = [&]() {
    const uint64_t w = bits_at(row, M, st.pos);
    bfinal = (int)(w & 1);
    const int btype = (int)((w >> 1) & 3);
    if (btype == 0) {
      const long long p = (st.pos + 3 + 7) & ~7LL;
      const uint64_t ws = bits_at(row, M, p);
      const int len = (int)(ws & 0xFFFF);
      const bool ok = len == (int)(((ws >> 16) & 0xFFFF) ^ 0xFFFF);
      if (threadIdx.x == 0) {  // tp < tok_cap - 1 here
        out.tk[st.tp] = TK_STORED;
        out.ta[st.tp] = len;
        out.tb[st.tp] = (int)((p + 32) >> 3);
      }
      ++st.tp;
      st.total += len;
      st.pos = p + 32 + 8LL * len;
      mode = !ok ? M_ERROR : (bfinal || stored_ends ? M_DONE : M_HEADER);
      if (!ok) err = ERR_STORED;
    } else if (btype == 1) {
      st.pos += 3;
      mode = M_TOKENS;
    } else {
      mode = M_ERROR;
      err = btype == 2 ? ERR_DYNAMIC : ERR_METHOD;
    }
  };

  if (!(flags & F_LATER) && st.in_bounds(nbits, end, tok_cap)) header();
  while (mode < M_DONE && st.in_bounds(nbits, end, tok_cap)) {
    if (mode == M_HEADER) header();
    if (mode == M_TOKENS) {
      bool eob;
      const int e = run_pass(pol, sh, win4, row, M, end, pwin, tok_cap, out,
                             st, eob);
      if (e != ERR_OK) {
        mode = M_ERROR;
        err = e;
      } else {
        mode = !eob ? M_TOKENS : (eob_ends || bfinal ? M_DONE : M_HEADER);
      }
    }
  }
  const bool clean =
      mode == M_DONE || (err == ERR_OK && st.pos >= end && mode == M_HEADER);
  if (!clean && err == ERR_OK) {
    err = st.tp >= tok_cap - 1 ? ERR_OVERFLOW : ERR_INPUT;
  }
  if (!resume) out.zero(st.tp, tok_cap);  // fresh buffers: past the last token
  if (threadIdx.x == 0) {
    ntok_out[lane] = st.tp;
    total_out[lane] = st.total;
    pos_out[lane] = (int)st.pos;
    err_out[lane] = err;
  }
}

}  // namespace

extern "C" int tokenize_static_launch(const void* rows, const void* end_bits,
                                      void* tk, void* ta, void* tb,
                                      void* ntok, void* total, void* pos,
                                      void* err, const void* resume,
                                      int flags, int B, int M, int tok_cap,
                                      int pwin, void* stream) {
  // one block of kThreads a lane; the window and the token slices take
  // dynamic shared memory
  static launch::DynSmem limit_static, limit_stream;
  const bool stream_lane = resume || flags;
  auto kernel = stream_lane ? tokenize_static_kernel<true>
                            : tokenize_static_kernel<false>;
  const size_t smem = 16 * (size_t)window_chunks(pwin) +
                      4 * (size_t)kThreads * slice_words(pwin);
  const cudaError_t e =
      (stream_lane ? limit_stream : limit_static).fit(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const int*)end_bits, (int*)tk, (int*)ta,
      (int*)tb, (int*)ntok, (int*)total, (int*)pos, (int*)err,
      (const int*)resume, flags, M, tok_cap, pwin);
  return (int)cudaGetLastError();
}
