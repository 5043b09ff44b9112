// The pass engine that the static (tokenize.cu) and the dynamic
// (tokenize_dyn.cu) tokenizers share: one block of kThreads a lane, which
// decodes a lane's Huffman block in passes of `pwin` bit positions, as the
// JAX tokenizer does.  A pass (run_pass):
//   1. stages its window of the stream, from the pass's first byte to
//      pwin / 8 + 16 bytes on, into dynamic shared memory with cp.async
//      (bytes past the row read as zero);
//   2. finds the true symbol starts by a fixed-point iteration.  The
//      window is cut into subsequences of S bits, one a thread, S wider
//      than the widest symbol (so a walk's exit lies in the next
//      subsequence).  Thread j walks p -> p + adv(p) from its entry e_j,
//      through terminals too, to its exit x_j, the first position past its
//      subsequence; then e_{j+1} <- x_j, until no entry changes.  e_0 is
//      the pass's start.  After round r the entries 0..r are on the true
//      chain (e_{j+1} follows from an exact e_j in one walk), so the
//      iteration ends within one round a subsequence, and it ends only
//      where every e_{j+1} = x_j, which is the true chain.  A walk from a
//      guess e_j = jS is exact from the first position it shares with the
//      true chain on; in runs of literal codes of one width a walk can stay
//      out of step for hundreds of bits, so the rounds a pass takes are
//      about that distance over S, and a round walks again only where an
//      entry moved.  A walk keeps what it needs to write its tokens before
//      its first terminal in the thread's own slice of shared memory (the
//      policy's keep());
//   3. takes the pass's first terminal (end-of-block or bad code) on the
//      chain as a block-wide minimum, and counts tokens and output bytes
//      before it with block scans;
//   4. copies the tokens out to their slots, only where the pass's tokens
//      fit: each warp writes its 32 threads' slices as one run of slots, so
//      neighbouring threads store neighbouring words.  A walk with more
//      tokens than its slice holds walks again and writes its own slots, at
//      the offset the block scan gave it.
// A pass ends at an end-of-block, a bad code, or the first chain position
// at or past the window; its error is ERR_OVERFLOW if its tokens do not
// fit, else ERR_DIST if a match reaches before the output start (all
// output of the lane so far counts), else ERR_BAD_CODE.  Positions at or
// past the lane's end bit decode as a bad code of width 1.
//
// A tokenizer gives the engine a policy P:
//   P::kMinSub                     the least S, wider than any symbol;
//   int cap                        tokens a slice holds;
//   P::Window window(win, off, room)  the pass's decoder: position `base`
//                                  of the lane is bit `off` of the shared
//                                  window `win`, and Sym at(p) decodes
//                                  position p (a bad code at or past room);
//   void keep(k, d, y)             the walk's k-th token, symbol y at bit d
//                                  of the thread's subsequence;
//   Sym token(w, o, lo, k)         the k-th token that slice o kept (its
//                                  subsequence starts at bit lo).
// The lane's state (bit position, tokens, output bytes) is the same in
// every thread of the block, so it needs no shared copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace pass {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = INT_MAX;

constexpr int ERR_OK = 0, ERR_BAD_CODE = 2, ERR_DIST = 4, ERR_OVERFLOW = 5,
              ERR_INPUT = 7;
constexpr int TK_LIT = 0, TK_MATCH = 1;
constexpr int K_LIT = 0, K_EOB = 1, K_MATCH = 2, K_BAD = 3;

// One candidate symbol: kind, total width adv (1 for K_BAD), literal byte
// or match length, match distance.
struct Sym {
  int kind, adv, ta, dist;
};

// Exclusive block scan of (a, b) over the block's threads; (ta, tb) get
// the block's totals.  wa, wb: kWarps ints of shared memory each.
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
  ta = wa[kWarps - 1];
  tb = wb[kWarps - 1];
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

// The window's 16-byte chunks: the most a pass stages (its first byte at
// most 15 bytes past an aligned address).
__host__ __device__ __forceinline__ int window_chunks(int pwin) {
  return (15 + (pwin + 7) / 8 + 16 + 15) / 16 + 1;
}

// Subsequence bits for passes of pwin bits: pwin over the threads, at
// least min_sub.
__host__ __device__ __forceinline__ int sub_bits(int pwin, int min_sub) {
  const int s = (pwin + kThreads - 1) / kThreads;
  return s > min_sub ? s : min_sub;
}

// Start staging a pass's window into win4: 16-byte chunks from the aligned
// address at or before the byte of bit `base`, pwin / 8 + 16 bytes on; a
// chunk's bytes past the row (M bytes) are zero-filled, and a chunk wholly
// past it is not read.  Commits the copies and returns the offset of the
// pass's first byte in the window; the caller waits (cp_wait) and
// synchronizes before reading.
__device__ __forceinline__ int stage_window(uint4* win4, const uint8_t* row,
                                            long long M, long long base,
                                            int pwin) {
  const uintptr_t first = (uintptr_t)(row + (base >> 3));
  const uintptr_t row_end = (uintptr_t)(row + M);
  const uintptr_t g0 = first & ~(uintptr_t)15;
  const int off_bytes = (int)(first - g0);
  const int nchunks = (off_bytes + (pwin + 7) / 8 + 16 + 15) / 16 + 1;
  for (int c = threadIdx.x; c < nchunks; c += blockDim.x) {
    const uintptr_t g = g0 + 16 * (uintptr_t)c;
    const long long left = (long long)row_end - (long long)g;
    if (left <= 0) {
      win4[c] = make_uint4(0, 0, 0, 0);
    } else {
      cp_async16(win4 + c, (const void*)g, left < 16 ? (int)left : 16);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return off_bytes;
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A walk of one subsequence from its entry up to `hi`: the exit (first
// position at or past hi), the first terminal on the way (kNone if none)
// with its width and kind, and before it the tokens (each passed to
// emit(k, position, symbol)), the output bytes, and the most that a
// distance reaches past the walk's own output (`need`, at least 0).
struct Seg {
  int exit, term, term_adv, n, produced, need;
  bool term_eob;
};

template <class Window, class Emit>
__device__ __forceinline__ Seg walk(const Window& w, int e, int hi,
                                    Emit emit) {
  Seg s{e, kNone, 0, 0, 0, 0, false};
  int p = e;
  while (p < hi) {
    if (p >= w.room) {  // bad codes of width 1 from here to the end
      if (s.term == kNone) {
        s.term = p;
        s.term_adv = 1;
      }
      p = hi;
      break;
    }
    const Sym y = w.at(p);
    if (s.term == kNone) {
      if (y.kind == K_EOB || y.kind == K_BAD) {
        s.term = p;
        s.term_adv = y.adv;
        s.term_eob = y.kind == K_EOB;
      } else {
        const bool m = y.kind == K_MATCH;
        if (m) s.need = max(s.need, y.dist - s.produced);
        emit(s.n++, p, y);
        s.produced += m ? y.ta : 1;
      }
    }
    p += y.adv;
  }
  s.exit = p;
  return s;
}

// The block's shared memory for the passes, besides the window and the
// slices: the subsequences' entries and token counts, the scan's warp
// totals, and the cut.
struct Shared {
  int ent[kThreads], pre[kThreads];
  int wa[kWarps], wb[kWarps];
  int term, term_adv, term_eob, exit;
};

// A lane's token slots.
struct Slots {
  int *tk, *ta, *tb;

  __device__ __forceinline__ void put(int i, const Sym& y) const {
    tk[i] = y.kind == K_MATCH ? TK_MATCH : TK_LIT;
    ta[i] = y.ta;
    tb[i] = y.dist;
  }
  // zero slots [from, to), the block's threads together
  __device__ __forceinline__ void zero(int from, int to) const {
    for (int i = from + threadIdx.x; i < to; i += blockDim.x) {
      tk[i] = ta[i] = tb[i] = 0;
    }
  }
};

// A lane's running state: the next bit, the tokens so far, the output
// bytes so far.
struct Lane {
  long long pos;
  int tp, total;

  // another pass may start here
  __device__ __forceinline__ bool in_bounds(long long nbits, long long end,
                                            int tok_cap) const {
    return pos <= nbits && pos < end && tp < tok_cap - 1;
  }
};

// One pass of the lane from st.pos, through the window win4 (then the
// slices) of the row's M bytes, up to the end bit `end`.  Advances st,
// sets eob where the pass ended at an end-of-block, and returns ERR_OK or
// the pass's error.  Every thread of the block calls it.
template <class P>
__device__ __forceinline__ int run_pass(P& pol, Shared& sh, uint4* win4,
                                        const uint8_t* row, long long M,
                                        long long end, int pwin, int tok_cap,
                                        const Slots& out, Lane& st,
                                        bool& eob) {
  const int tid = threadIdx.x;
  const int S = sub_bits(pwin, P::kMinSub);
  const int nsub = (pwin + S - 1) / S;
  const int lo = tid * S, hi = min(lo + S, pwin);
  const bool mine = tid < nsub;
  const long long base = st.pos;
  __syncthreads();  // the last pass is done with its shared memory

  // 1. stage the window
  const int off_bytes = stage_window(win4, row, M, base, pwin);
  if (mine) sh.ent[tid] = lo;
  if (tid == 0) sh.term = kNone;
  cp_wait();
  __syncthreads();
  const long long room = end - base;
  const auto w = pol.window(
      (const uint32_t*)win4, 8 * off_bytes + (int)(base & 7),
      (int)(room < 0 ? -1 : (room > pwin ? pwin : room)));

  // 2. the fixed point of the subsequences' entries; a walk is redone
  // only where its entry moved
  auto keep = [&](int k, int p, const Sym& y) { pol.keep(k, p - lo, y); };
  Seg seg{0, kNone, 0, 0, 0, 0, false};
  int walked = -1;
  while (true) {
    const int e = mine ? sh.ent[tid] : walked;
    if (e != walked) {
      seg = walk(w, e, hi, keep);
      walked = e;
    }
    __syncthreads();  // every entry is read before any is replaced
    bool changed = false;
    if (tid + 1 < nsub && sh.ent[tid + 1] != seg.exit) {
      sh.ent[tid + 1] = seg.exit;
      changed = true;
    }
    if (!__syncthreads_or(changed)) break;
  }

  // 3. the first terminal on the chain, the tokens and bytes before it
  if (mine && seg.term != kNone) atomicMin(&sh.term, seg.term);
  if (tid == nsub - 1) sh.exit = seg.exit;
  __syncthreads();
  const int cut = sh.term;
  if (mine && seg.term == cut && cut != kNone) {
    sh.term_adv = seg.term_adv;
    sh.term_eob = seg.term_eob;
  }
  const bool live = mine && sh.ent[tid] <= cut;
  int before_n = live ? seg.n : 0, before_p = live ? seg.produced : 0;
  int n, produced;
  scan2(before_n, before_p, n, produced, sh.wa, sh.wb);
  sh.pre[tid] = before_n;
  const bool cap_ok = st.tp + n < tok_cap - 1;
  const bool far = cap_ok && live && seg.need > st.total + before_p;
  const bool too_far = __syncthreads_or(far) != 0;  // pre[] is complete

  // 4. copy the tokens out: warp v writes the slots of its threads'
  // slices, [pre[32v], pre[32v + 32]), one slot a lane; a walk whose
  // tokens overflowed its slice walks again and writes its own slots
  if (cap_ok) {
    const int v0 = tid & ~31, lane32 = tid & 31;
    const int stop = v0 + 32 < kThreads ? sh.pre[v0 + 32] : n;
    int o = v0;  // the slice that holds slot i: pre[o] <= i < pre[o + 1]
    for (int i = sh.pre[v0] + lane32; i < stop; i += 32) {
      while (o + 1 < v0 + 32 && sh.pre[o + 1] <= i) ++o;
      const int count = (o + 1 < kThreads ? sh.pre[o + 1] : n) - sh.pre[o];
      if (count > pol.cap) continue;
      out.put(st.tp + i, pol.token(w, o, o * S, i - sh.pre[o]));
    }
    if (live && seg.n > pol.cap) {
      const int slot0 = st.tp + before_n;
      walk(w, sh.ent[tid], hi,
           [&](int k, int, const Sym& y) { out.put(slot0 + k, y); });
    }
  }
  const bool hit = cut != kNone;
  eob = hit && sh.term_eob;
  st.pos = hit ? base + cut + sh.term_adv : base + sh.exit;
  if (cap_ok) {
    st.tp += n;
    st.total += produced;
  }
  if (too_far) return ERR_DIST;
  if (!cap_ok) return ERR_OVERFLOW;
  return hit && !eob ? ERR_BAD_CODE : ERR_OK;
}

}  // namespace pass
