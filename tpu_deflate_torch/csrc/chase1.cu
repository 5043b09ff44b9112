// Single-lane boundary chase: the entry phase of one orbit in every 64-bit
// tile, and the visited positions of one orbit.
//
// Replaces: tpu_deflate/kernels/chase1.py, ent_from_phi (Pallas body
// _ent_kernel) and visited_from_adv (_visit_kernel).  The TPU form composes
// the per-tile transfer maps up a binary hierarchy with lane rolls and
// packed selects, because one TPU core walks a pointer chain slowly.
//
// Bound on the card.  ent_from_phi reads 512 KiB of maps at T = 8192,
// 0.16 us of memory time; its chain is log2(T) compositions deep.
// visited_from_adv moves 96 KiB at T = 128, and its orbit is a chain of up
// to 8192 dependent steps, which the design below cuts to a chain inside
// a tile, a composition over the tiles and a walk inside a tile.
//
// Design of ent_from_phi: the composition spread over the card, one launch
// (beside a memset of its arrival counter).  Only one phase crosses
// between blocks, never a map.
//   1. Load.  Block b owns a run of kRun consecutive tiles (all T where T
//      is smaller) and loads their packed words with 16-byte loads into
//      shared memory, a map a row, padded so that a warp's rows fall in
//      distinct banks.  Every entry of 64 or more becomes the sink 64.
//   2. Compose.  An inclusive scan by doubling (log2 kRun rounds, a thread
//      a word of four entries): S_k = f_k o ... o f_0 over the run, so the
//      block holds every tile's prefix map.
//   3. Publish.  The prefix maps P_t (identity for the run's first tile,
//      S_{k-1} after it) go to scratch in device memory entry-major: for
//      each entry x, P_t[x] of the run's tiles side by side.  The run's
//      composite S_last goes beside them; then a barrier, and one thread
//      adds the block's arrival to the counter (atom.acq_rel.gpu: it
//      releases the block's stores that the barrier ordered before it).
//   4. Carry, in the last block to arrive (no block ever waits): the
//      composites, kChunk at a time in shared memory; thread (g, e)
//      composes group g's kGroup composites on phase e, thread 0 walks p0
//      through the group maps, thread g through its group's composites,
//      giving each block's entry phase x_b.  Then block b's tiles take the
//      row of entry x_b, 4 tiles a word read through L2 (ld.global.cg: the
//      rows were written by other blocks).
// A phase outside [0, 64) (STOP = 191 or anything larger, or a p0 of 64
// or more) has left the orbit and stays out: such a tile's entry is -1,
// as in the TPU form, where a select keeps an index outside the map's
// range.
//
// Design of visited_from_adv, tile-parallel as the TPU form, spread over
// blocks of kVisitRun tiles: a position's jump stays inside its tile or
// lands in the next one (1 <= adv <= 64 where no terminator is, as a
// header's code-length symbols are: at most 14 bits; anything else
// traps).  One launch, beside a memset of its ticket and maps.
//   1. Load.  A block takes its run of tiles from an atomic ticket, reads
//      its columns of every row of the inputs (in-tile position q, the
//      tiles side by side; a run's tiles are adjacent in a row), every
//      load issued before the first store, and scatters them into shared
//      memory a tile a row: nxt = q + adv, or 255 at a terminator.
//   2. Exits.  A copy of nxt doubles in place, a word of four entries a
//      thread, so that a warp holds two tiles and orders its rounds alone
//      (at most 6): each entry becomes the position where its chain
//      leaves the tile, 64 + the next tile's phase, or 255 at a
//      terminator.
//   3. The run's map.  Thread e (each phase, and the sink 64) walks its
//      phase through the run's tiles, keeping the phase at which it enters
//      each tile; where the start p0 lies in the run, its tile takes p0's
//      phase whatever came in.  The map from the phase entering the run
//      to the phase leaving it is published, a word a thread
//      (st.release.gpu), every byte with bit 7 set.
//   4. Look-back.  The block polls the words of the maps of all runs
//      before it at once (ld.acquire.gpu) until each has bit 7 in every
//      byte, and one thread carries the sink through them: the phase
//      entering the run.  Runs wait only on runs of lower tickets, which
//      publish before they wait.
//   5. Marks.  Each tile's entry phase is a lookup of step 3's; a thread
//      a tile walks nxt from it, setting a bit a visited position (the
//      terminator included), at most 64 steps.
//   6. Write.  The run's columns of every row, a bit a position.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;
constexpr int kRun = 64;            // tiles a block of ent_kernel composes
constexpr int kEntThreads = 256;
constexpr int kWords = TILE / 4;    // a map: 64 one-byte entries, 16 words
constexpr int kRowW = kWords + 1;   // a map's words in shared memory, padded
constexpr int kSink = TILE;         // every phase outside [0, 64)
constexpr int kChunk = 2 * kRun;    // composites the last block holds at once
constexpr int kGroup = 16;          // composites a group map covers
constexpr int kVisitMaxT = 256;     // visited_from_adv: 64 T <= 16384
constexpr int kVisitRun = 8;        // tiles a block of visit_kernel takes
constexpr int kVisitThreads = 256;
constexpr int kVisitPer = kVisitRun * TILE / kVisitThreads;  // loads a thread
constexpr int kStride = TILE + 4;   // a tile's bytes in shared memory, padded
constexpr int kPhases = TILE + 1;   // the phases and the sink
constexpr int kMapWords = 17;       // a run's map: an entry a phase and the sink
static_assert(kVisitRun * TILE / 4 <= kVisitThreads, "a word of the exits a thread");
// a wait longer than about a second (a poll is at least a trip through L2)
// can only be a fault: the kernel traps instead of hanging the card
constexpr int kMaxPolls = 1 << 22;

// Entry x of a map held as words in memory; the sink stays the sink.
__device__ __forceinline__ int step_map(const uint32_t* m, int x) {
  return x < kSink ? ((const uint8_t*)m)[x] : kSink;
}

// Four entries x (a word) through map m.
__device__ __forceinline__ uint32_t step4(const uint32_t* m, uint32_t x) {
  uint32_t y = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    y |= (uint32_t)step_map(m, (x >> (8 * b)) & 0xFF) << (8 * b);
  }
  return y;
}

// The phase at which a chain entering a tile at phase x enters the next
// tile, from the tile's exits (64 + that phase, or 255 at a terminator);
// the sink stays the sink.
__device__ __forceinline__ int exit_phase(const uint8_t* exits, int x) {
  if (x >= kSink) return kSink;
  const int j = exits[x];
  return j < 2 * TILE ? j - TILE : kSink;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// scratch: an int arrival counter (16 bytes with padding), then the
// composites uint32[nb][kWords], then the prefix maps entry-major,
// uint8[nb][64][run] (entry x of the prefix maps of block b's tiles in a
// row).
__global__ void __launch_bounds__(kEntThreads)
    ent_kernel(const uint32_t* __restrict__ phi, const int* __restrict__ p0,
               int* __restrict__ ent, uint8_t* scratch, int T, int run) {
  __shared__ uint32_t buf[2 * kRun * kRowW];  // two levels of the scan;
                                              // the last block's composites
  __shared__ uint32_t gmap[kChunk / kGroup * kRowW];
  __shared__ int gent[kChunk / kGroup];
  __shared__ uint8_t carry[kChunk];
  __shared__ int s_last;
  const int tid = threadIdx.x, b = blockIdx.x, nb = gridDim.x;
  int* counter = (int*)scratch;
  uint32_t* comp_g = (uint32_t*)(scratch + 16);
  uint32_t* pre_g = comp_g + (size_t)nb * kWords;

  // 1. load: row g of the packed maps holds entries 4g..4g+3 of each tile
  const int q4 = run / 4;
  for (int i = tid; i < kWords * q4; i += kEntThreads) {
    const int g = i / q4, q = i % q4;
    const uint4 w = __ldg((const uint4*)(phi + (size_t)g * T + (size_t)b * run) + q);
    uint32_t* dst = buf + 4 * q * kRowW + g;
    dst[0] = __vminu4(w.x, 0x40404040u);
    dst[kRowW] = __vminu4(w.y, 0x40404040u);
    dst[2 * kRowW] = __vminu4(w.z, 0x40404040u);
    dst[3 * kRowW] = __vminu4(w.w, 0x40404040u);
  }
  __syncthreads();

  // 2. compose: S_k <- S_k o S_{k-d}, from one level to the other
  uint32_t* src = buf;
  uint32_t* dst = buf + kRun * kRowW;
  for (int d = 1; d < run; d <<= 1) {
    for (int i = tid; i < run * kWords; i += kEntThreads) {
      const int k = i / kWords, g = i % kWords;
      const uint32_t w = src[k * kRowW + g];
      dst[k * kRowW + g] =
          k >= d ? step4(src + k * kRowW, src[(k - d) * kRowW + g]) : w;
    }
    __syncthreads();
    uint32_t* t = src;
    src = dst;
    dst = t;
  }

  // 3. publish the composite and the prefix maps, entry-major (for entry
  // x, P_k[x] of the run's tiles k in a row), then arrive
  const int rw = run / 4;  // words of a row
  uint32_t* pre_b = pre_g + (size_t)b * TILE * rw;
  for (int i = tid; i < TILE * rw; i += kEntThreads) {
    const int x = i / rw, k = 4 * (i % rw);
    uint32_t w = 0;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int y = k + h == 0 ? x : ((const uint8_t*)(src + (k + h - 1) * kRowW))[x];
      w |= (uint32_t)y << (8 * h);
    }
    pre_b[i] = w;
  }
  if (tid < kWords) comp_g[(size_t)b * kWords + tid] = src[(run - 1) * kRowW + tid];
  // the barrier orders every thread's stores before one thread's
  // acquire-release add, which the last block's add reads
  __syncthreads();
  if (tid == 0) s_last = atom_add_acq_rel(counter, 1) == nb - 1;
  __syncthreads();
  if (!s_last) return;

  // 4. the last block: each block's entry phase, then every tile's
  const int start = *p0;
  int x = start >= 0 && start < TILE ? start : kSink;  // thread 0's walk
  for (int c0 = 0; c0 < nb; c0 += kChunk) {
    const int n = min(kChunk, nb - c0), groups = (n + kGroup - 1) / kGroup;
    for (int i = tid; i < n * kWords; i += kEntThreads) {
      const int k = i / kWords, g = i % kWords;
      buf[k * kRowW + g] = __ldcg(comp_g + (size_t)(c0 + k) * kWords + g);
    }
    __syncthreads();
    for (int i = tid; i < groups * TILE; i += kEntThreads) {
      const int gi = i / TILE, e = i % TILE;
      int y = e;
      for (int j = gi * kGroup; j < min(n, (gi + 1) * kGroup); ++j) {
        y = step_map(buf + j * kRowW, y);
      }
      ((uint8_t*)(gmap + gi * kRowW))[e] = (uint8_t)y;
    }
    __syncthreads();
    if (tid == 0) {
      for (int gi = 0; gi < groups; ++gi) {
        gent[gi] = x;
        x = step_map(gmap + gi * kRowW, x);
      }
    }
    __syncthreads();
    if (tid < groups) {
      int y = gent[tid];
      for (int j = tid * kGroup; j < min(n, (tid + 1) * kGroup); ++j) {
        carry[j] = (uint8_t)y;
        y = step_map(buf + j * kRowW, y);
      }
    }
    __syncthreads();
    // block c0 + j's row for its entry phase: four tiles a word
    for (int i = tid; i < n * rw; i += kEntThreads) {
      const int j = i / rw, w = i % rw, xb = carry[j];
      const uint32_t v =
          xb < kSink ? __ldcg(pre_g + ((size_t)(c0 + j) * TILE + xb) * rw + w)
                     : 0xFFFFFFFFu;
      int4 e;
      e.x = (int)(v & 0xFF), e.y = (int)((v >> 8) & 0xFF);
      e.z = (int)((v >> 16) & 0xFF), e.w = (int)(v >> 24);
      e.x = e.x < kSink ? e.x : -1, e.y = e.y < kSink ? e.y : -1;
      e.z = e.z < kSink ? e.z : -1, e.w = e.w < kSink ? e.w : -1;
      *(int4*)(ent + (size_t)(c0 + j) * run + 4 * w) = e;
    }
    __syncthreads();  // before the next chunk's composites overwrite buf
  }
}

// scratch: int32 words: [0] the ticket counter, then the runs' maps,
// kMapWords words each: a byte for each phase entering the run and for the
// sink (which a run holding the start maps to a phase), each with bit 7
// set, so that a word with a byte under 0x80 is not published yet.
__global__ void __launch_bounds__(kVisitThreads)
    visit_kernel(const int* __restrict__ advT, const int* __restrict__ termT,
                 const int* __restrict__ p0, int* __restrict__ vis,
                 int* scratch, int T, int run) {
  __shared__ __align__(4) uint8_t nxt[kVisitRun * kStride];
  __shared__ __align__(4) uint8_t jmp[kVisitRun * kStride];
  __shared__ uint8_t pre[kVisitRun * kPhases];  // the phase entering tile k
  __shared__ __align__(4) uint8_t own[4 * kMapWords];  // the run's map
  __shared__ __align__(4) uint8_t maps[kVisitMaxT / kVisitRun * 4 * kMapWords];
  __shared__ unsigned long long seen[kVisitRun];
  __shared__ int s_run, s_in;
  const int tid = threadIdx.x, P = TILE * T, lr = __ffs(run) - 1;
  uint32_t* map_g = (uint32_t*)(scratch + 1);
  if (tid == 0) s_run = atomicAdd(scratch, 1);
  const int start = __ldg(p0);
  __syncthreads();
  const int b = s_run, tb = b << lr;  // the run's first tile
  const int t0 = start >= 0 && start < P ? start / TILE : -1;
  const int e0 = start & (TILE - 1);

  // 1. load the run's columns, every load before the first store
  int av[kVisitPer], tv[kVisitPer];
#pragma unroll
  for (int k = 0; k < kVisitPer; ++k) {
    const int i = tid + k * kVisitThreads;
    const int g = (i >> lr) * T + tb + (i & (run - 1));
    av[k] = i < TILE * run ? __ldg(advT + g) : 1;
    tv[k] = i < TILE * run ? __ldg(termT + g) : 1;
  }
  bool outside = false;
#pragma unroll
  for (int k = 0; k < kVisitPer; ++k) {
    const int i = tid + k * kVisitThreads;
    if (i < TILE * run) {
      const int q = i >> lr, at = (i & (run - 1)) * kStride + q;
      outside |= tv[k] == 0 && (av[k] < 1 || av[k] > TILE);
      const uint8_t v = tv[k] != 0 ? 255 : (uint8_t)(q + av[k]);
      nxt[at] = v;
      jmp[at] = v;
    }
  }
  if (__syncthreads_or(outside)) __trap();  // a jump past the next tile

  // 2. exits, a word of four entries a thread, so a warp holds two tiles:
  // every entry doubles in place until it has left its tile, rounds
  // ordered by the warp alone (an entry read while another lane rewrites
  // it is still a later point of the same chain)
  if (tid < run * (TILE / 4)) {
    const unsigned lanes = run > 1 ? 0xFFFFFFFFu : 0xFFFFu;  // a warp's words
    uint8_t* row = jmp + (tid / (TILE / 4)) * kStride;
    uint32_t* word = (uint32_t*)row + tid % (TILE / 4);
    for (int r = 0; r < 6; ++r) {
      const uint32_t x = *word;
      bool inside = false;
      if (__vcmpgeu4(x, 0x40404040u) != 0xFFFFFFFFu) {
        uint32_t y = 0;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          uint32_t e = (x >> (8 * h)) & 0xFF;
          if (e < TILE) {
            e = row[e];
            inside |= e < TILE;
          }
          y |= e << (8 * h);
        }
        *word = y;
      }
      if (!__any_sync(lanes, inside)) break;
      __syncwarp(lanes);
    }
  }
  __syncthreads();

  // 3. the run's map, keeping each phase's entry into each tile; the
  // start's tile takes the start's phase.  Published a word a thread.
  if (tid < 4 * kMapWords) {
    int y = tid;
    if (tid < kPhases) {
      for (int k = 0; k < run; ++k) {
        if (tb + k == t0) y = e0;
        pre[k * kPhases + tid] = (uint8_t)y;
        y = exit_phase(jmp + k * kStride, y);
      }
    }
    own[tid] = (uint8_t)(0x80 | (tid < kPhases ? y : 0));
  }
  __syncthreads();
  if (tid < kMapWords) {
    st_release((int*)map_g + b * kMapWords + tid, ((const int*)own)[tid]);
  }

  // 4. look-back: the maps of the runs before, each word polled until its
  // bytes carry bit 7; then the sink carried through them
  for (int i = tid; i < b * kMapWords; i += kVisitThreads) {
    const int* at = (const int*)map_g + i;
    int w;
    for (int polls = 0; __vcmpgeu4(w = ld_acquire(at), 0x80808080u) != 0xFFFFFFFFu;
         ++polls) {
      if (polls == kMaxPolls) __trap();
      __nanosleep(32);
    }
    ((uint32_t*)maps)[i] = (uint32_t)w & 0x7F7F7F7Fu;
  }
  __syncthreads();
  if (tid == 0) {
    int x = kSink;
    for (int j = 0; j < b; ++j) x = maps[j * 4 * kMapWords + x];
    s_in = x;
  }
  __syncthreads();

  // 5. marks: a thread a tile walks its part of the orbit
  if (tid < run) {
    const uint8_t* row = nxt + tid * kStride;
    unsigned long long m = 0;
    for (int y = pre[tid * kPhases + s_in]; y < TILE;) {
      m |= 1ull << y;
      y = row[y] == 255 ? TILE : row[y];
    }
    seen[tid] = m;
  }
  __syncthreads();

  // 6. write the run's columns
  for (int i = tid; i < TILE * run; i += kVisitThreads) {
    vis[(i >> lr) * T + tb + (i & (run - 1))] =
        (int)((seen[i & (run - 1)] >> (i >> lr)) & 1);
  }
}

}  // namespace

// phi: int32[16, T] packed maps, T a power of two, 32 <= T, 16-byte
// aligned; p0: int32[1] on the device; ent: int32[T]; scratch: int32[
// scratch_words], at least 4 + 16 * (T / min(T, 64) + T), its counter
// zeroed here.
extern "C" int ent_from_phi_launch(const void* phi, const void* p0, void* ent,
                                   void* scratch, int scratch_words, int T,
                                   void* stream) {
  const int run = T < kRun ? T : kRun;
  const int nb = T / run;
  const long long words = 4 + (long long)kWords * (nb + T);
  if (T < 32 || (T & (T - 1)) || words > scratch_words) {
    return (int)cudaErrorInvalidValue;
  }
  if ((uintptr_t)phi & 15) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  ent_kernel<<<nb, kEntThreads, 0, s>>>((const uint32_t*)phi, (const int*)p0,
                                        (int*)ent, (uint8_t*)scratch, T, run);
  return (int)cudaGetLastError();
}

// advT, termT, vis: int32[64, T], T a power of two, 64 T <= 16 * 1024;
// p0: int32[1] on the device; scratch: int32[scratch_words], at least 1 +
// 17 T / min(T, 8), zeroed here.
extern "C" int visited_from_adv_launch(const void* advT, const void* termT,
                                       const void* p0, void* vis,
                                       void* scratch, int scratch_words, int T,
                                       void* stream) {
  if (T < 1 || T > kVisitMaxT || (T & (T - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const int run = T < kVisitRun ? T : kVisitRun, nb = T / run;
  const int words = 1 + kMapWords * nb;
  if (words > scratch_words) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(scratch, 0, words * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  visit_kernel<<<nb, kVisitThreads, 0, s>>>(
      (const int*)advT, (const int*)termT, (const int*)p0, (int*)vis,
      (int*)scratch, T, run);
  return (int)cudaGetLastError();
}
