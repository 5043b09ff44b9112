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
// serial is short: five rounds of map doubling inside a tile (every
// literal/length code of the block is at least 2 bits, so a symbol that
// does not end the block is at least 2 bits wide and 32 links cross a
// tile), 33 visits a tile, and one scan across the tiles.
//
// k1d, a block of 512 threads for 2048 bit positions (32 tiles), a
// position a thread in each of 4 chunks:
//   1. Dead blocks.  A block whose first bit lies at or past the end bit
//      writes the constant fields of K_BAD and STOP maps, as the plain
//      version gives them there, and stops: no table load, no decode.
//   2. Candidates.  The block's window bytes and the lane's tables go to
//      shared memory, the code limits to registers; each thread decodes
//      the symbols starting at its positions (dyn_sym.cuh; a position at
//      or past the end bit is K_BAD of width 1), stores their fields kind
//      | adv | ta | dist - 1, and puts their one-step maps in shared
//      memory: 255 at a terminator (end-of-block or bad code), else the
//      phase + adv.  Bytes at or past pw / 8 read as zero, as in the TPU
//      form, whose last tile sees no next tile.
//   3. Maps by doubling.  A warp holds a tile's 64 one-step maps in
//      registers, lane l phases l and l + 32; five rounds of m <- m o m,
//      two shuffles a phase each, with exits (>= 64) and
//      terminators (255) absorbing, give exactly what 32 links of the
//      one-step map give: the entry phase in the next tile, or STOP; a
//      chain still inside the tile keeps (x - 64) & 0xFF, as plain.
//   4. Maps in whole words.  phi (int32[16, T], phases 4g..4g+3 of tile t
//      in the bytes of word [g, t]) is staged in shared memory, then
//      stored a word a thread: a block's 32 tiles of one phase group are
//      128 contiguous bytes.
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
constexpr unsigned STOP4 = 0x01010101u * STOP;  // four STOP maps in a word
constexpr unsigned BAD_FIELDS = ((unsigned)K_BAD << 30) | (1u << 24);
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

// k1d: a block of kK1Threads threads decodes kK1Chunks chunks of
// kK1Threads bit positions, a position a thread a chunk
constexpr int kK1Threads = 512;
constexpr int kK1Chunks = 4;
constexpr int kK1Bits = kK1Chunks * kK1Threads;
constexpr int kK1Tiles = kK1Bits / TILE;  // tiles a k1d block maps

// 64 bits of the window from its bit l on
__device__ __forceinline__ uint64_t window64(const unsigned* win, int l) {
  const unsigned* x = win + (l >> 5);
  return (uint64_t)__funnelshift_r(x[1], x[2], l) << 32 |
         __funnelshift_r(x[0], x[1], l);
}

__global__ void __launch_bounds__(kK1Threads)
    k1d_kernel(const uint8_t* __restrict__ row, int nbytes,
               const int* __restrict__ end_bits, const int* __restrict__ tab,
               int* __restrict__ plane, unsigned* __restrict__ phi, int T) {
  __shared__ __align__(16) Tables tabs;
  __shared__ unsigned win[kK1Bits / 32 + 4];  // the block's bytes and 16 more
  __shared__ uint8_t m0s[kK1Bits];
  __shared__ unsigned words[16 * kK1Tiles];  // [phase group][tile]
  const int tid = threadIdx.x;
  const int bit0 = blockIdx.x * kK1Bits;
  const int end = *end_bits;
  unsigned* phib = phi + blockIdx.x * kK1Tiles;  // the block's first tile

  // 1. a dead block (uniform across it)
  if (bit0 >= end) {
    for (int l = tid; l < kK1Bits; l += kK1Threads) plane[bit0 + l] = (int)BAD_FIELDS;
    for (int i = tid; i < 16 * kK1Tiles; i += kK1Threads) {
      phib[(size_t)(i / kK1Tiles) * T + i % kK1Tiles] = STOP4;
    }
    return;
  }

  // 2. candidates, the code limits in registers
  load_tables(tabs, tab);
  const int byte0 = bit0 / 8;
  for (int k = tid; k < kK1Bits / 8 + 16; k += kK1Threads) {
    ((uint8_t*)win)[k] = byte0 + k < nbytes ? __ldg(row + byte0 + k) : 0;
  }
  __syncthreads();
  int lim[2][16];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 v = ((const int4*)tabs.lim[c])[q];
      lim[c][4 * q] = v.x, lim[c][4 * q + 1] = v.y;
      lim[c][4 * q + 2] = v.z, lim[c][4 * q + 3] = v.w;
    }
  }
#pragma unroll
  for (int c = 0; c < kK1Chunks; ++c) {
    const int l = c * kK1Threads + tid;
    Sym s{K_BAD, 1, 0, 0};
    if (bit0 + l < end) {
      s = dyn_symbol(window64(win, l), lim[0], tabs.rd[0], tabs.lit_sym,
                     lim[1], tabs.rd[1], tabs.dist_sym);
    }
    plane[bit0 + l] = (int)(((unsigned)s.kind << 30) | ((unsigned)s.adv << 24) |
                            ((unsigned)s.ta << 15) |
                            (s.kind == K_MATCH ? (unsigned)(s.dist - 1) : 0u));
    m0s[l] = (uint8_t)(s.kind == K_EOB || s.kind == K_BAD ? 255 : l % TILE + s.adv);
  }
  __syncthreads();

  // 3. maps by doubling: warp w maps tiles w, w + 32, ..., lane e its
  // phases e and e + 32
  const int e = tid & 31;
  uint8_t* wb = (uint8_t*)words;
  for (int lt = tid >> 5; lt < kK1Tiles; lt += kK1Threads / 32) {
    int a = m0s[lt * TILE + e], b = m0s[lt * TILE + e + 32];
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const int aa = __shfl_sync(0xFFFFFFFFu, a, a & 31);
      const int ab = __shfl_sync(0xFFFFFFFFu, b, a & 31);
      const int ba = __shfl_sync(0xFFFFFFFFu, a, b & 31);
      const int bb = __shfl_sync(0xFFFFFFFFu, b, b & 31);
      a = a >= TILE ? a : (a < 32 ? aa : ab);
      b = b >= TILE ? b : (b < 32 ? ba : bb);
    }
    wb[((e >> 2) * kK1Tiles + lt) * 4 + (e & 3)] =
        (uint8_t)(a >= 2 * TILE ? STOP : ((a - TILE) & 0xFF));
    wb[(((e + 32) >> 2) * kK1Tiles + lt) * 4 + (e & 3)] =
        (uint8_t)(b >= 2 * TILE ? STOP : ((b - TILE) & 0xFF));
  }
  __syncthreads();

  // 4. the maps, a word a thread, a phase group's kK1Tiles words contiguous
  for (int i = tid; i < 16 * kK1Tiles; i += kK1Threads) {
    phib[(size_t)(i / kK1Tiles) * T + i % kK1Tiles] = words[i];
  }
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
// phi: int32[16, pw / 64]; pw a multiple of kK1Bits.
extern "C" int tokenize_hier_k1d_launch(const void* row, int nbytes,
                                        const void* end_bits, const void* tab,
                                        void* plane, void* phi, int pw,
                                        void* stream) {
  if (pw < kK1Bits || pw % kK1Bits) return (int)cudaErrorInvalidValue;
  k1d_kernel<<<pw / kK1Bits, kK1Threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)row, nbytes, (const int*)end_bits, (const int*)tab,
      (int*)plane, (unsigned*)phi, pw / TILE);
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
