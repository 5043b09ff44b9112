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
// runs it, in passes of `pwin` bit positions.  A pass:
//   1. stages its window of the stream, from the pass's first byte to
//      pwin / 8 + 16 bytes on, into dynamic shared memory with cp.async
//      (bytes past the row read as zero);
//   2. finds the true symbol starts by a fixed-point iteration.  The
//      window is cut into subsequences of S >= 32 bits, one a thread.
//      Thread j walks p -> p + adv(p) from its entry e_j, through
//      terminals too, to its exit x_j, the first position past its
//      subsequence; then e_{j+1} <- x_j, until no entry changes.  e_0 is
//      the pass's start.  After round r the entries 0..r are on the true
//      chain (e_{j+1} follows from an exact e_j in one walk), so the
//      iteration ends within one round a subsequence, and it ends only
//      where every e_{j+1} = x_j, which is the true chain.  A walk from a
//      guess e_j = jS is exact from the first position it shares with the
//      true chain on; in runs of 8-bit literal codes a walk can stay out
//      of step for hundreds of bits, so the rounds a pass takes are about
//      that distance over S, and a round walks again only where an entry
//      moved.  A walk keeps the tokens it passes before its first
//      terminal, packed, in the thread's own slice of shared memory: a
//      token is at least 8 bits wide, so a slice of S / 8 + 1 holds them;
//   3. takes the pass's first terminal (end-of-block or bad code) on the
//      chain as a block-wide minimum, and counts tokens and output bytes
//      before it with block scans;
//   4. copies the tokens out to their slots, only where the pass's tokens
//      fit (cap_ok): each warp writes its 32 threads' slices as one run of
//      slots, so neighbouring threads store neighbouring words.
// The pass's rules are those of the JAX tokenizer: positions at or past
// the lane's end bit decode as a bad code of width 1; a pass ends at an
// end-of-block, a bad code, or the first chain position at or past the
// window; its error is ERR_OVERFLOW if its tokens do not fit, else
// ERR_DIST if a match reaches before the output start, else ERR_BAD_CODE.
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

#include <climits>

namespace {

constexpr int ERR_OK = 0, ERR_METHOD = 1, ERR_BAD_CODE = 2, ERR_DIST = 4,
              ERR_OVERFLOW = 5, ERR_STORED = 6, ERR_INPUT = 7,
              ERR_DYNAMIC = 8;
constexpr int TK_LIT = 0, TK_MATCH = 1, TK_STORED = 2;
constexpr int M_HEADER = 0, M_TOKENS = 3, M_DONE = 4, M_ERROR = 5;
constexpr int K_LIT = 0, K_EOB = 1, K_MATCH = 2, K_BAD = 3;
constexpr int F_GO_ON = 1, F_ONE_BLOCK = 2, F_LATER = 4;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_SUB = 32;  // a symbol is at most 31 bits wide
constexpr int NONE = INT_MAX;

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

// A walk of one subsequence from its entry up to `hi`: the exit (first
// position at or past hi), the first terminal on the way (NONE if none)
// with its width and kind, and before it the tokens (packed into `out`:
// match << 25 | ta << 16 | dist), the output bytes, and the most that a
// distance reaches past the walk's own output (`need`, at least 0).
struct Seg {
  int exit, term, term_adv, n, produced, need;
  bool term_eob;
};

__device__ __forceinline__ Seg walk(const Window& w, int e, int hi,
                                    uint32_t* out) {
  Seg s{e, NONE, 0, 0, 0, 0, false};
  int p = e;
  while (p < hi) {
    if (p >= w.room) {  // bad codes of width 1 from here to the end
      if (s.term == NONE) {
        s.term = p;
        s.term_adv = 1;
      }
      p = hi;
      break;
    }
    const Sym y = w.at(p);
    if (s.term == NONE) {
      if (y.kind == K_EOB || y.kind == K_BAD) {
        s.term = p;
        s.term_adv = y.adv;
        s.term_eob = y.kind == K_EOB;
      } else {
        const bool m = y.kind == K_MATCH;
        if (m) s.need = max(s.need, y.dist - s.produced);
        out[s.n++] = (uint32_t)m << 25 | (uint32_t)y.ta << 16 | (uint32_t)y.dist;
        s.produced += m ? y.ta : 1;
      }
    }
    p += y.adv;
  }
  s.exit = p;
  return s;
}

// Exclusive block scan of (a, b) over the block's threads; (ta, tb) get
// the block's totals.  wa, wb: WARPS ints of shared memory each.
__device__ __forceinline__ void scan2(int& a, int& b, int& ta, int& tb,
                                      int* wa, int* wb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xFFFFFFFFu, ia, o);
    const int y = __shfl_up_sync(0xFFFFFFFFu, ib, o);
    if (lane >= o) {
      ia += x;
      ib += y;
    }
  }
  if (lane == 31) {
    wa[warp] = ia;
    wb[warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    int x = wa[lane], y = wb[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xFFFFFFFFu, x, o);
      const int v = __shfl_up_sync(0xFFFFFFFFu, y, o);
      if (lane >= o) {
        x += u;
        y += v;
      }
    }
    wa[lane] = x;  // inclusive over warps
    wb[lane] = y;
  }
  __syncthreads();
  const int pa = warp ? wa[warp - 1] : 0, pb = warp ? wb[warp - 1] : 0;
  ta = wa[WARPS - 1];
  tb = wb[WARPS - 1];
  a = pa + ia - a;
  b = pb + ib - b;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid)
               : "memory");
}

// Subsequence bits, and words of a thread's token slice (odd, so the
// threads of a warp write their slices in different banks).
__host__ __device__ __forceinline__ int sub_bits(int pwin) {
  return max(MIN_SUB, (pwin + THREADS - 1) / THREADS);
}
__host__ __device__ __forceinline__ int slice_words(int pwin) {
  return ((sub_bits(pwin) + 7) / 8 + 1) | 1;
}
// The window's 16-byte chunks: the most a pass stages (its first byte at
// most 15 bytes past an aligned address).
__host__ __device__ __forceinline__ int window_chunks(int pwin) {
  return (15 + (pwin + 7) / 8 + 16 + 15) / 16 + 1;
}

// kStream: the lane is a whole stream (flags and resume are read); without
// it they are compiled out, and the lane stops at its first end-of-block.
template <bool kStream>
__global__ void __launch_bounds__(THREADS) tokenize_static_kernel(
    const uint8_t* __restrict__ rows, const int* __restrict__ end_bits,
    int* __restrict__ tk, int* __restrict__ ta, int* __restrict__ tb,
    int* __restrict__ ntok_out, int* __restrict__ total_out,
    int* __restrict__ pos_out, int* __restrict__ err_out,
    const int* __restrict__ resume, int flags, int M, int tok_cap, int pwin) {
  extern __shared__ uint4 win4[];  // the window, then the token slices
  __shared__ int ent[THREADS], pre[THREADS];
  __shared__ int wa[WARPS], wb[WARPS];
  __shared__ int s_term, s_term_adv, s_term_eob, s_exit;
  __shared__ uint32_t lit_tab[512], dist_tab[32];

  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
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
  // the lane's state: every thread holds the same copy
  long long pos = resume ? resume[3 * lane] : 0;
  int tp = resume ? resume[3 * lane + 1] : 0;
  int total = resume ? resume[3 * lane + 2] : 0;
  int mode = M_HEADER, err = ERR_OK, bfinal = 0;
  // what ends the lane: any end-of-block, any block, or a final block
  const bool eob_ends = !(flags & F_GO_ON) || (flags & F_ONE_BLOCK);
  const bool stored_ends = (flags & F_ONE_BLOCK) != 0;

  // subsequences of S bits, one a thread, each with its token slice
  const int S = sub_bits(pwin);
  const int nsub = (pwin + S - 1) / S;
  const int lo = tid * S, hi = min(lo + S, pwin);
  const bool mine = tid < nsub;
  const int slice = slice_words(pwin);
  uint32_t* toks = (uint32_t*)(win4 + window_chunks(pwin));
  uint32_t* my_toks = toks + tid * slice;

  fill_tables(lit_tab, dist_tab);  // read after the first pass's barriers

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
      if (tid == 0) {  // tp < tok_cap - 1 here
        tkl[tp] = TK_STORED;
        tal[tp] = len;
        tbl[tp] = (int)((p + 32) >> 3);
      }
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
    __syncthreads();  // the last pass is done with its shared memory

    // 1. stage the window: 16-byte chunks from the aligned address at or
    // before the pass's first byte; a chunk's bytes past the row are
    // zero-filled, and a chunk wholly past it is not read
    const uintptr_t first = (uintptr_t)(row + (base >> 3));
    const uintptr_t row_end = (uintptr_t)(row + M);
    const uintptr_t g0 = first & ~(uintptr_t)15;
    const int off_bytes = (int)(first - g0);
    const int nchunks = (off_bytes + (pwin + 7) / 8 + 16 + 15) / 16 + 1;
    for (int c = tid; c < nchunks; c += THREADS) {
      const uintptr_t g = g0 + 16 * (uintptr_t)c;
      const long long left = (long long)row_end - (long long)g;
      if (left <= 0) {
        win4[c] = make_uint4(0, 0, 0, 0);
      } else {
        cp_async16(win4 + c, (const void*)g, left < 16 ? (int)left : 16);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (mine) ent[tid] = lo;
    if (tid == 0) s_term = NONE;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const long long room = end - base;
    const Window w{(const uint32_t*)win4, lit_tab, dist_tab,
                   8 * off_bytes + (int)(base & 7),
                   (int)(room < 0 ? -1 : (room > pwin ? pwin : room))};

    // 2. the fixed point of the subsequences' entries; a walk is redone
    // only where its entry moved
    Seg seg{0, NONE, 0, 0, 0, 0, false};
    int walked = -1;
    while (true) {
      const int e = mine ? ent[tid] : walked;
      if (e != walked) {
        seg = walk(w, e, hi, my_toks);
        walked = e;
      }
      __syncthreads();  // every entry is read before any is replaced
      bool changed = false;
      if (tid + 1 < nsub && ent[tid + 1] != seg.exit) {
        ent[tid + 1] = seg.exit;
        changed = true;
      }
      if (!__syncthreads_or(changed)) break;
    }

    // 3. the first terminal on the chain, the tokens and bytes before it
    if (mine && seg.term != NONE) atomicMin(&s_term, seg.term);
    if (tid == nsub - 1) s_exit = seg.exit;
    __syncthreads();
    const int cut = s_term;
    if (mine && seg.term == cut && cut != NONE) {
      s_term_adv = seg.term_adv;
      s_term_eob = seg.term_eob;
    }
    const bool live = mine && ent[tid] <= cut;
    int before_n = live ? seg.n : 0, before_p = live ? seg.produced : 0;
    int n, produced;
    scan2(before_n, before_p, n, produced, wa, wb);
    pre[tid] = before_n;
    const bool cap_ok = tp + n < tok_cap - 1;
    const bool far = cap_ok && live && seg.need > total + before_p;
    const bool too_far = __syncthreads_or(far) != 0;  // pre[] is complete

    // 4. copy the tokens out: warp v writes the slots of its threads'
    // slices, [pre[32v], pre[32v + 32]), one slot a lane
    if (cap_ok) {
      const int v0 = tid & ~31, lane32 = tid & 31;
      const int stop = v0 + 32 < THREADS ? pre[v0 + 32] : n;
      int o = v0;  // the slice that holds slot i: pre[o] <= i < pre[o + 1]
      for (int i = pre[v0] + lane32; i < stop; i += 32) {
        while (o + 1 < v0 + 32 && pre[o + 1] <= i) ++o;
        const uint32_t t = toks[o * slice + (i - pre[o])];
        tkl[tp + i] = (int)(t >> 25);
        tal[tp + i] = (int)((t >> 16) & 511);
        tbl[tp + i] = (int)(t & 0xFFFF);
      }
    }
    const bool hit = cut != NONE;
    const bool eob = hit && s_term_eob;
    pos = hit ? base + cut + s_term_adv : base + s_exit;
    if (cap_ok) {
      tp += n;
      total += produced;
    }
    if ((hit && !eob) || too_far || !cap_ok) {
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
  if (!resume) {  // fresh buffers: zero the slots past the last token
    for (int i = tp + tid; i < tok_cap; i += THREADS) {
      tkl[i] = 0;
      tal[i] = 0;
      tbl[i] = 0;
    }
  }
  if (tid == 0) {
    ntok_out[lane] = tp;
    total_out[lane] = total;
    pos_out[lane] = (int)pos;
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
  // one block of THREADS a lane; the window and the token slices take
  // dynamic shared memory, above 48 KB by an opt-in
  auto kernel = (resume || flags) ? tokenize_static_kernel<true>
                                   : tokenize_static_kernel<false>;
  const size_t smem = 16 * (size_t)window_chunks(pwin) +
                      4 * (size_t)THREADS * slice_words(pwin);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const int*)end_bits, (int*)tk, (int*)ta,
      (int*)tb, (int*)ntok, (int*)total, (int*)pos, (int*)err,
      (const int*)resume, flags, M, tok_cap, pwin);
  return (int)cudaGetLastError();
}
