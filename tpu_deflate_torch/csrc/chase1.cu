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
// to 8192 dependent steps.
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
// Design of visited_from_adv, one block: pointer doubling over the 64 T
// positions in shared memory.  jump[p] = p + adv[p], or the sink P at a
// terminator; each round marks jump[p] wherever p is marked, then doubles
// every jump.  After ceil(log2(P + 1)) + 1 rounds every position of the
// orbit is marked (the sink is not a position); a mark written during a
// round only adds positions of the orbit earlier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;
constexpr int THREADS = 1024;
constexpr int kRun = 64;            // tiles a block of ent_kernel composes
constexpr int kEntThreads = 256;
constexpr int kWords = TILE / 4;    // a map: 64 one-byte entries, 16 words
constexpr int kRowW = kWords + 1;   // a map's words in shared memory, padded
constexpr int kSink = TILE;         // every phase outside [0, 64)
constexpr int kChunk = 2 * kRun;    // composites the last block holds at once
constexpr int kGroup = 16;          // composites a group map covers

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

__global__ void __launch_bounds__(THREADS)
    visit_kernel(const int* __restrict__ advT, const int* __restrict__ termT,
                 const int* __restrict__ p0, int* __restrict__ vis, int T,
                 int rounds) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int P = TILE * T;
  int* jump = (int*)smem;                    // [P + 1], the last is the sink
  uint8_t* mark = (uint8_t*)(jump + P + 1);  // [P + 1]
  const int start = *p0;
  // position p = 64 t + q sits at row q, column t of the inputs
  for (int p = threadIdx.x; p <= P; p += blockDim.x) {
    int j = P;
    if (p < P) {
      const int at = (p % TILE) * T + p / TILE;
      if (termT[at] == 0) {
        const int n = p + advT[at];
        j = n < 0 ? 0 : (n > P ? P : n);
      }
    }
    jump[p] = j;
    mark[p] = p == start;
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      if (mark[p]) mark[jump[p]] = 1;
    }
    __syncthreads();
    // double every jump: read all, then write all
    constexpr int MAXPER = 16;
    int nj[MAXPER];
#pragma unroll
    for (int k = 0; k < MAXPER; ++k) {
      const int p = threadIdx.x + k * blockDim.x;
      if (p < P) nj[k] = jump[jump[p]];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MAXPER; ++k) {
      const int p = threadIdx.x + k * blockDim.x;
      if (p < P) jump[p] = nj[k];
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    vis[(p % TILE) * T + p / TILE] = mark[p];
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

// advT, termT, vis: int32[64, T], 64 T <= 16 * 1024; p0: int32[1] on the
// device.
extern "C" int visited_from_adv_launch(const void* advT, const void* termT,
                                       const void* p0, void* vis, int T,
                                       int rounds, void* stream) {
  const int P = TILE * T;
  const int smem = (P + 1) * (int)sizeof(int) + (P + 1);
  cudaError_t e = cudaFuncSetAttribute(
      visit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  visit_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)advT, (const int*)termT, (const int*)p0, (int*)vis, T,
      rounds);
  return (int)cudaGetLastError();
}
