// Decode stage 1 of one static- or dynamic-tree block in one lane, tile
// parallel: a candidate symbol at every bit position, per-tile transfer
// maps, and a walk of every 64-bit tile at once.
//
// Replaces: tpu_deflate/kernels/tokenize_dyn.py, tokenize_dyn_batch with
// hier=True, tier=2 (Pallas bodies _k1d_kernel and _k3d_kernel; between
// them chase1.ent_from_phi, csrc/chase1.cu).  The TPU form builds the same
// maps with five rounds of packed-select pointer doubling and compacts the
// tokens with one-hot MXU products.
//
// Bound on the card: bytes and launches.  k1d reads the window (64 KiB at
// pw = 2^19) and writes a 4-byte field and a map byte per bit position,
// 2.5 MiB; k3d reads the fields of the true symbols only (the next
// symbol's phase follows from them) and writes the tokens.  What is
// serial is short: a chain of at most 32 links inside a tile (every
// literal/length code of the block is at least 2 bits, so a symbol that
// does not end the block is at least 2 bits wide), 33 visits a tile, and
// one scan across the tiles.
//
// k1d, one thread per bit position, 16 tiles a block: the block's window
// bytes and the lane's tables go to shared memory; each thread decodes the
// symbol starting at its position (dyn_sym.cuh; a position at or past the
// end bit is K_BAD of width 1), stores its fields kind | adv | ta |
// dist - 1, and puts its one-step map in shared memory: 255 at a
// terminator (end-of-block or bad code), else its phase + adv.  Then
// thread (tile, e) follows the tile's one-step maps from phase e for up to
// 32 links: the entry phase in the next tile, or STOP.  Bytes at or past
// pw / 8 read as zero, as in the TPU form, whose last tile sees no next
// tile.
//
// k3d, the walk spread over the card: a block of kK3Tiles threads walks
// kK3Tiles consecutive tiles, one a thread, in one launch.
//   1. Ticket.  A block takes its run of tiles from an atomic ticket, so
//      a block waits only on blocks that are already running.  A block
//      whose first tile's 32768-bit chunk starts at or past the end bit
//      walks nothing (the TPU form's dead-chunk rule; dead tiles are a
//      suffix): it publishes an empty count and arrives.
//   2. Stage.  The block's slice of the plane (256 bytes a tile) goes to
//      shared memory in 16-byte loads, so both walks read shared memory.
//   3. Count walk.  Each tile from its entry phase (ent_from_phi) for at
//      most WLK = 33 visits: its tokens and output bytes, a bad symbol,
//      the end-of-block word.  A block-wide exclusive scan gives each
//      tile its offset inside the run.
//   4. Look-back.  Warp 0 publishes the run's count, packed with a flag
//      in one 64-bit word (flag 1: the run's own count; flag 2: the count
//      of every tile up to the run's last), then reads the words of the
//      32 runs before it at once, waiting only where a flag is unset,
//      and sums back to the nearest flag 2; then publishes its own
//      flag 2.  Words are stored with st.release.gpu and read with
//      ld.acquire.gpu; a word without a flag is never summed.
//   5. Write walk.  The same walk again from shared memory writes each
//      token at its slot (below tokcap only) and checks each distance
//      against the output before the token, out_base (TAB_OUTBASE) bytes
//      of earlier blocks of the lane included.
//   6. Meta.  Each block adds its bad-code and distance flags, its
//      largest end-of-block word and its count to four words by atomics,
//      then arrives (atom.acq_rel.gpu after a barrier); the last to
//      arrive writes ntok, out_total, end_pos and err with today's rules.
// The token buffers, meta and the scratch (tickets, arrivals, the four
// words, a status word a run) are one zeroed allocation of the caller's:
// slots past the count stay zero.  A wait that outlasts kMaxPolls polls
// traps: a fault becomes a launch error, never a hung card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dyn_sym.cuh"

namespace {

using namespace dyn;

constexpr int TILE = 64;
constexpr int STOP = 191;
constexpr int THREADS = 1024;
constexpr int K1_TILES = THREADS / TILE;  // tiles per k1d block
constexpr int WLK = 33;                   // visits per tile
constexpr int kK3Tiles = 128;             // tiles a k3d block walks, one a thread
constexpr int kK3MaxT = 8192;             // tiles of the widest window, 2^19 bits
constexpr int kCtrl = 8;                  // control words before the status words
// a count packs as ntok | nbytes << kNtokBits: at most 33 tokens a tile
// of 258 bytes each, so under 2^20 tokens and 2^27 bytes at kK3MaxT
constexpr int kNtokBits = 20;
constexpr unsigned long long kValue = (1ull << 62) - 1;
constexpr unsigned long long kRunCount = 1ull << 62;  // flag 1
constexpr unsigned long long kPrefix = 2ull << 62;    // flag 2
// a wait longer than about a second (a poll is at least a trip through L2)
// can only be a fault
constexpr int kMaxPolls = 1 << 22;
static_assert(kK3MaxT * WLK < (1 << kNtokBits), "token counts fit their field");

__global__ void __launch_bounds__(THREADS)
    k1d_kernel(const uint8_t* __restrict__ row, int nbytes,
               const int* __restrict__ end_bits, const int* __restrict__ tab,
               int* __restrict__ plane, uint8_t* __restrict__ phi, int T) {
  __shared__ Tables tabs;
  __shared__ uint8_t win[K1_TILES * 8 + 8];
  __shared__ uint8_t m0s[THREADS];
  load_tables(tabs, tab);
  const int byte0 = blockIdx.x * K1_TILES * 8;
  for (int k = threadIdx.x; k < K1_TILES * 8 + 8; k += blockDim.x) {
    win[k] = byte0 + k < nbytes ? __ldg(row + byte0 + k) : 0;
  }
  __syncthreads();

  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int q = p % TILE;
  Sym s{K_BAD, 1, 0, 0};
  if (p < *end_bits) {
    uint64_t w = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      w |= (uint64_t)win[(threadIdx.x >> 3) + k] << (8 * k);
    }
    s = dyn_symbol(w >> (p & 7), tabs.lim[0], tabs.rd[0], tabs.lit_sym,
                   tabs.lim[1], tabs.rd[1], tabs.dist_sym);
  }
  plane[p] = (int)(((unsigned)s.kind << 30) | ((unsigned)s.adv << 24) |
                   ((unsigned)s.ta << 15) |
                   (s.kind == K_MATCH ? (unsigned)(s.dist - 1) : 0u));
  m0s[threadIdx.x] =
      (uint8_t)(s.kind == K_EOB || s.kind == K_BAD ? 255 : q + s.adv);
  __syncthreads();

  // thread (tile, e): the tile's transfer map at entry phase e
  const int lt = threadIdx.x / TILE, e = threadIdx.x % TILE;
  const int t = blockIdx.x * K1_TILES + lt;
  int x = e;
  for (int k = 0; k < 32 && x < TILE; ++k) x = m0s[lt * TILE + x];
  const int out = x >= 2 * TILE ? STOP : ((x - TILE) & 0xFF);
  phi[(((size_t)(e >> 2) * T + t) << 2) + (e & 3)] = (uint8_t)out;
}

// The fields of the symbol at bit p, v = its plane word: (kind, adv, ta,
// dist).
struct Field {
  int kind, adv, ta, dist;
};

__device__ __forceinline__ Field field_of(int v, int p, int end) {
  const unsigned u = (unsigned)v;
  Field f{(int)(u >> 30), (int)((u >> 24) & 0x3F), (int)((u >> 15) & 0x1FF),
          (int)(u & 0x7FFF) + 1};
  if (p >= end) f.kind = K_BAD;
  return f;
}

// Exclusive block-wide prefix sum of v; *total gets the sum.
__device__ unsigned long long block_exscan(unsigned long long v,
                                           unsigned long long* warp_sums,
                                           unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long o = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    unsigned long long w = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long o = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += o;
    }
    if (lane < nw) warp_sums[lane] = w;
    if (lane == nw - 1) *total = w;
  }
  __syncthreads();
  return inc - v + (warp ? warp_sums[warp - 1] : 0);
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Warp 0 of run vb, whose own count is agg: publishes it, sums the counts
// of the runs before it back to the nearest published prefix, publishes
// its own prefix, and returns the count of every tile before the run.
__device__ unsigned long long look_back(unsigned long long* status, int vb,
                                        unsigned long long agg) {
  const int lane = threadIdx.x & 31;
  if (vb == 0) {
    if (lane == 0) st_release(status, kPrefix | agg);
    return 0;
  }
  if (lane == 0) st_release(status + vb, kRunCount | agg);
  unsigned long long excl = 0;
  for (int j = vb - 1;; j -= 32) {
    const int i = j - lane;
    unsigned long long w = kPrefix;  // before the first run: a prefix of 0
    if (i >= 0) {
      for (int polls = 0; ((w = ld_acquire(status + i)) >> 62) == 0; ++polls) {
        if (polls == kMaxPolls) __trap();
        __nanosleep(32);
      }
    }
    const unsigned pre = __ballot_sync(0xFFFFFFFFu, (w >> 62) == 2);
    const int nearest = pre ? __ffs(pre) - 1 : 31;
    unsigned long long v = lane <= nearest ? (w & kValue) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
    excl += v;
    if (pre) break;
  }
  if (lane == 0) st_release(status + vb, kPrefix | (excl + agg));
  return excl;
}

// scratch: int32 words, zero at launch: [0] tickets, [1] arrivals, [2] 1 +
// the largest end-of-block word, [3] flags (1 a bad symbol, 2 a distance
// too far), [4, 6) the count of all tiles (uint64), then from word kCtrl
// one uint64 status word a run.
__global__ void __launch_bounds__(kK3Tiles)
    k3d_kernel(const int* __restrict__ plane, const int* __restrict__ ent,
               const int* __restrict__ end_bits, const int* __restrict__ tab,
               int* __restrict__ tk, int* __restrict__ ta,
               int* __restrict__ tb, int* __restrict__ meta, int* scratch,
               int chunk, int tokcap) {
  __shared__ int4 stage[kK3Tiles * TILE / 4];
  __shared__ unsigned long long warp_sums[32];
  __shared__ unsigned long long s_agg, s_excl;
  __shared__ int s_vb, s_last;
  const int tid = threadIdx.x;
  int* ctrl = scratch;
  unsigned long long* status = (unsigned long long*)(scratch + kCtrl);
  const int end = *end_bits;

  // 1. ticket
  if (tid == 0) s_vb = atomicAdd(ctrl, 1);
  __syncthreads();
  const int vb = s_vb, t0 = vb * kK3Tiles, t = t0 + tid;
  bool bad = false, far = false;
  unsigned long long agg = 0;
  if (TILE * (t0 - t0 % chunk) >= end) {  // a dead run: nothing to walk
    if (tid == 0) st_release(status + vb, kRunCount);
  } else {
    // 2. stage the run's fields
    const int4* src = (const int4*)plane + (size_t)t0 * (TILE / 4);
    for (int i = tid; i < kK3Tiles * TILE / 4; i += kK3Tiles) {
      stage[i] = __ldg(src + i);
    }
    const int start = TILE * (t - t % chunk) < end ? __ldg(ent + t) : -1;
    const int out_base = __ldg(tab + TAB_OUTBASE);
    __syncthreads();
    const int* fields = (const int*)stage + tid * TILE;

    // 3. count walk
    unsigned ntok = 0, nbytes = 0;
    int eob = -1;
    for (int v = 0, x = start; v < WLK && (unsigned)x < (unsigned)TILE; ++v) {
      const int p = TILE * t + x;
      const Field f = field_of(fields[x], p, end);
      if (f.kind == K_LIT || f.kind == K_MATCH) {
        ++ntok;
        nbytes += f.kind == K_LIT ? 1 : f.ta;
      }
      bad |= f.kind == K_BAD;
      if (f.kind == K_EOB) eob = max(eob, (p << 6) | f.adv);
      x = f.kind == K_EOB || f.kind == K_BAD ? TILE : x + f.adv;
    }
    if (eob >= 0) atomicMax(ctrl + 2, eob + 1);
    const unsigned long long base = block_exscan(
        ntok | ((unsigned long long)nbytes << kNtokBits), warp_sums, &s_agg);
    agg = s_agg;

    // 4. look-back
    if (tid < 32) {
      const unsigned long long excl = look_back(status, vb, agg);
      if (tid == 0) s_excl = excl;
    }
    __syncthreads();

    // 5. write walk
    const unsigned long long at = s_excl + base;
    unsigned slot = (unsigned)(at & ((1u << kNtokBits) - 1));
    unsigned run = (unsigned)(at >> kNtokBits) + (unsigned)out_base;
    for (int v = 0, x = start; v < WLK && (unsigned)x < (unsigned)TILE; ++v) {
      const Field f = field_of(fields[x], TILE * t + x, end);
      if (f.kind == K_LIT || f.kind == K_MATCH) {
        const bool m = f.kind == K_MATCH;
        far |= m && (unsigned)f.dist > run;
        if (slot < (unsigned)tokcap) {
          tk[slot] = m ? TK_MATCH : TK_LIT;
          ta[slot] = f.ta;
          tb[slot] = m ? f.dist : 0;
        }
        ++slot;
        run += m ? f.ta : 1;
      }
      x = f.kind == K_EOB || f.kind == K_BAD ? TILE : x + f.adv;
    }
  }

  // 6. the run's flags and count, then arrive; the last to arrive writes
  // meta
  const bool any_bad = __syncthreads_or(bad);
  const bool any_far = __syncthreads_or(far);
  if (tid == 0) {
    if (any_bad || any_far) atomicOr(ctrl + 3, (any_bad ? 1 : 0) | (any_far ? 2 : 0));
    if (agg) atomicAdd((unsigned long long*)(ctrl + 4), agg);
    s_last = atom_add_acq_rel(ctrl + 1, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || tid != 0) return;
  const unsigned long long total = __ldcg((const unsigned long long*)(ctrl + 4));
  const int flags = __ldcg(ctrl + 3), eob_pk = __ldcg(ctrl + 2) - 1;
  const int n = (int)(total & ((1u << kNtokBits) - 1));
  int err;
  if (flags & 2) {
    err = ERR_DIST;
  } else if (!(n < tokcap - 8)) {
    err = ERR_OVERFLOW;
  } else if (flags & 1) {
    err = ERR_BAD_CODE;
  } else {
    err = eob_pk >= 0 ? ERR_OK : ERR_INPUT;
  }
  int end_pos = eob_pk >= 0 ? (eob_pk >> 6) + (eob_pk & 63) : end;
  if (end <= 3) {  // an empty lane
    err = ERR_OK;
    end_pos = 0;
  }
  meta[0] = n;
  meta[1] = (int)(total >> kNtokBits);
  meta[2] = end_pos;
  meta[3] = err;
}

}  // namespace

// row: uint8[M] of one lane, nbytes = min(M, pw / 8); plane: int32[pw];
// phi: int32[16, pw / 64].
extern "C" int tokenize_hier_k1d_launch(const void* row, int nbytes,
                                        const void* end_bits, const void* tab,
                                        void* plane, void* phi, int pw,
                                        void* stream) {
  k1d_kernel<<<pw / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)row, nbytes, (const int*)end_bits, (const int*)tab,
      (int*)plane, (uint8_t*)phi, pw / TILE);
  return (int)cudaGetLastError();
}

// plane: int32[64 T], 16-byte aligned; ent: int32[T]; tk, ta, tb:
// int32[tokcap], zero; meta: int32[4] = ntok, out_total, end_pos, err;
// scratch: int32[scratch_words], zero, 8-byte aligned, at least 8 + 2 T /
// 128 words.  T a multiple of 128, at most 8192.
extern "C" int tokenize_hier_k3d_launch(const void* plane, const void* ent,
                                        const void* end_bits, const void* tab,
                                        void* tk, void* ta, void* tb,
                                        void* meta, void* scratch,
                                        int scratch_words, int T, int chunk,
                                        int tokcap, void* stream) {
  const int runs = T / kK3Tiles;
  if (T < kK3Tiles || T % kK3Tiles || T > kK3MaxT || chunk < 1 ||
      kCtrl + 2LL * runs > scratch_words) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)plane & 15) || ((uintptr_t)scratch & 7)) {
    return (int)cudaErrorMisalignedAddress;
  }
  k3d_kernel<<<runs, kK3Tiles, 0, (cudaStream_t)stream>>>(
      (const int*)plane, (const int*)ent, (const int*)end_bits,
      (const int*)tab, (int*)tk, (int*)ta, (int*)tb, (int*)meta,
      (int*)scratch, chunk, tokcap);
  return (int)cudaGetLastError();
}
