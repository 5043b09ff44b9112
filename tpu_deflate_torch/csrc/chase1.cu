// Single-lane boundary chase: the entry phase of one orbit in every 64-bit
// tile, and the visited positions of one orbit.
//
// Replaces: tpu_deflate/kernels/chase1.py, ent_from_phi (Pallas body
// _ent_kernel) and visited_from_adv (_visit_kernel).  The TPU form composes
// the per-tile transfer maps up a binary hierarchy with lane rolls and
// packed selects, because one TPU core walks a pointer chain slowly.
//
// Bound on the card: the dependent chain.  ent_from_phi reads 512 KiB of
// maps at T = 8192, 0.16 us of memory time, but the orbit crosses the tiles
// one after another; each step is one dependent read.  Walked by one
// thread through device memory, that is T reads of several hundred cycles
// each.  visited_from_adv moves 96 KiB at T = 128, and its orbit is a chain
// of up to 8192 dependent steps.
//
// Design of ent_from_phi, one block, all in shared memory but the maps:
//   1. thread i composes the maps of its run of T / 1024 consecutive tiles
//      for all 64 entry phases (64 independent chains of reads);
//   2. 64 x (1024 / 32) threads compose runs of 32 of those, one entry
//      each; thread 0 walks the orbit of p0 through the 32 group maps,
//      thread g through the 32 run maps of group g, thread i through its
//      own tiles, writing the entry phase of each.
// A phase outside [0, 64) (STOP = 191 or anything larger) has left the
// orbit and stays out: such a tile's entry is -1, as in the TPU form,
// where a select keeps an index outside the map's range.
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
constexpr int GROUP = 32;      // runs composed per group map
constexpr int ROW = TILE + 4;  // bytes per map in shared memory, padded
                               // so that 32 maps fall in 32 banks

// Entry e of tile t in K1d's packed maps int32[16, T] (four entries an
// int32, little-endian).
__device__ __forceinline__ int map_entry(const uint8_t* phi, int T, int t,
                                         int e) {
  return __ldg(phi + (((size_t)(e >> 2) * T + t) << 2) + (e & 3));
}

__device__ __forceinline__ bool inside(int x) {
  return (unsigned)x < (unsigned)TILE;
}

__global__ void __launch_bounds__(THREADS)
    ent_kernel(const uint8_t* __restrict__ phi, const int* __restrict__ p0,
               int* __restrict__ ent, int T, int runs) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* run_map = smem;                        // [runs][ROW]
  uint8_t* grp_map = run_map + runs * ROW;        // [runs / GROUP][ROW]
  int* run_ent = (int*)(grp_map + (runs / GROUP) * ROW);  // [runs]
  int* grp_ent = run_ent + runs;                  // [runs / GROUP]
  const int per = T / runs;
  const int groups = runs / GROUP;
  const int i = threadIdx.x;

  // 1. the composite map of run i
  if (i < runs) {
    uint8_t* m = run_map + i * ROW;
    for (int e = 0; e < TILE; ++e) m[e] = (uint8_t)e;
    for (int s = 0; s < per; ++s) {
      const int t = i * per + s;
#pragma unroll 8
      for (int e = 0; e < TILE; ++e) {
        const int x = m[e];
        if (inside(x)) m[e] = (uint8_t)map_entry(phi, T, t, x);
      }
    }
  }
  __syncthreads();

  // 2. the composite map of each group of GROUP runs, one entry a thread
  for (int k = i; k < groups * TILE; k += blockDim.x) {
    const int g = k / TILE, e = k % TILE;
    int x = e;
    for (int j = 0; j < GROUP && inside(x); ++j) {
      x = run_map[(g * GROUP + j) * ROW + x];
    }
    grp_map[g * ROW + e] = (uint8_t)(inside(x) ? x : 255);
  }
  __syncthreads();

  // 3. the orbit of p0: through the groups, the runs, the tiles
  if (i == 0) {
    int x = *p0;
    for (int g = 0; g < groups; ++g) {
      grp_ent[g] = x;
      if (inside(x)) x = grp_map[g * ROW + x];
    }
  }
  __syncthreads();
  if (i < groups) {
    int x = grp_ent[i];
    for (int j = 0; j < GROUP; ++j) {
      run_ent[i * GROUP + j] = x;
      if (inside(x)) x = run_map[(i * GROUP + j) * ROW + x];
    }
  }
  __syncthreads();
  if (i < runs) {
    int x = run_ent[i];
    for (int s = 0; s < per; ++s) {
      const int t = i * per + s;
      ent[t] = inside(x) ? x : -1;
      if (inside(x)) x = map_entry(phi, T, t, x);
    }
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

// phi: int32[16, T] packed maps, T a power of two, 32 <= T; p0: int32[1]
// on the device; ent: int32[T].
extern "C" int ent_from_phi_launch(const void* phi, const void* p0, void* ent,
                                   int T, void* stream) {
  const int runs = T < THREADS ? T : THREADS;
  const int smem = runs * ROW + (runs / GROUP) * ROW +
                   (runs + runs / GROUP) * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      ent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ent_kernel<<<1, runs, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)phi, (const int*)p0, (int*)ent, T, runs);
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
