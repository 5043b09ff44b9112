// Back-reference resolution: the value at the root of each output
// position's parent chain.
//
// Replaces: tpu_deflate/kernels/resolve.py, resolve_roots (Pallas body
// _resolve_kernel).  The TPU form gathers parent[parent[p]] with one-hot
// products on the matrix unit, over byte planes that stay exact in bf16,
// which limits a row to 2^16 positions and the kernel to 8 rounds with an
// XLA finisher.  Here a thread reads parent[p] directly, so a row may have
// any length and every chain is followed to its root.
//
// Bound on the card: bytes, one read of parent and val and one write of
// the result, 12 bytes a position.  What is serial: a chain that crosses
// many tiles (a distance-1 run over a row crosses every tile), a read
// through L2 a tile crossed.
//
// Design: two launches and no memset; the kernel boundary orders them, so
// nothing waits on a flag.
//   1. Tiles.  A block takes one tile of kTile positions of a row.  It
//      loads the tile's parents into shared memory, a parent inside the
//      tile as its index there, one outside as -1 - its row position (an
//      "exit").  Pointer jumping in shared memory until a round moves
//      nothing, at most log2(kTile) + 1 rounds: each pointer then rests on
//      a root of the tile or on an exit.  Each position's entry goes to
//      the pointer table ptr in device memory as a row position, its root
//      or its exit, and where the root lies in the tile, out[p] =
//      val[root].  No block waits for another.
//   2. Chase.  A thread takes kPer positions of a row.  A position whose
//      entry lies outside its tile follows the table, x = ptr[x], until x
//      is its own entry (a root), reading through L2 (ld.global.cg, never
//      the read-only path or L1, which could hold stale lines).  After
//      each step it writes the position it reached over its own entry, so
//      a chase that passes through it later jumps that far at once: the
//      chases together jump pointers, without rounds.  A thread's kPer
//      chases step together, so their reads are in flight at once.  Then
//      out[p] = val[root].
//
// Why it is exact: an entry only ever holds a position on its own
// position's chain, strictly nearer the root unless the position is a
// root (whose entry is itself).  A chase reads old or new entries in any
// mix, and either moves it toward the root, so it ends there; chains are
// acyclic, and exits may point forward or backward.  A chase longer than
// the row can only be a cycle, which the contract excludes: it traps, so
// a fault becomes a launch error, never a hung card; so does a tile whose
// pointers still move after as many rounds as its chains can need.
//
// Indices are 32-bit: a row's base pointer is formed once a thread, and
// rows and tiles come from the block index.  Parents are clamped into the
// row, so a malformed input reads no memory outside it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileLog = 12;
constexpr int kTile = 1 << kTileLog;  // positions a block of launch 1 resolves
constexpr int kThreads = 1024;
constexpr int kMaxRounds = kTileLog + 2;
constexpr int kChaseThreads = 256;
constexpr int kPer = 2;  // positions a thread of launch 2 chases
constexpr int kSpan = kChaseThreads * kPer;

__device__ __forceinline__ int clamp_idx(int p, int N) {
  return p < 0 ? 0 : (p >= N ? N - 1 : p);
}

__global__ void __launch_bounds__(kThreads)
    resolve_tile_kernel(const int* __restrict__ parent,
                        const int* __restrict__ val, int* __restrict__ ptr,
                        int* __restrict__ out, int N, int ntiles) {
  __shared__ int ref[kTile];
  const int row = blockIdx.x / ntiles, t0 = (blockIdx.x % ntiles) * kTile;
  const int w = min(kTile, N - t0);
  const size_t base = (size_t)row * N + t0;
  const int* par = parent + base;
  for (int k = threadIdx.x; k < w; k += kThreads) {
    const int q = clamp_idx(__ldg(par + k), N);
    ref[k] = q >= t0 && q < t0 + w ? q - t0 : -1 - q;
  }
  __syncthreads();
  for (int round = 0;; ++round) {
    if (round == kMaxRounds) __trap();  // only a cycle moves this long
    bool moved = false;
    for (int k = threadIdx.x; k < w; k += kThreads) {
      const int r = ref[k];
      if (r >= 0) {
        const int r2 = ref[r];
        if (r2 != r) {
          ref[k] = r2;
          moved = true;
        }
      }
    }
    if (!__syncthreads_or(moved)) break;
  }
  const int* vrow = val + (size_t)row * N;
  for (int k = threadIdx.x; k < w; k += kThreads) {
    const int r = ref[k];
    if (r >= 0) {
      ptr[base + k] = t0 + r;
      out[base + k] = __ldg(vrow + t0 + r);
    } else {
      ptr[base + k] = -1 - r;
    }
  }
}

__global__ void __launch_bounds__(kChaseThreads)
    resolve_chase_kernel(int* ptr, const int* __restrict__ val,
                         int* __restrict__ out, int N, int spans) {
  const int row = blockIdx.x / spans;
  const int c0 = (blockIdx.x % spans) * kSpan + threadIdx.x;
  int* prow = ptr + (size_t)row * N;
  const int* vrow = val + (size_t)row * N;
  int* orow = out + (size_t)row * N;
  int x[kPer];
  unsigned active = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = c0 + j * kChaseThreads;
    x[j] = p;
    if (p < N) {
      // only this thread writes p's entry: this is what launch 1 left
      const int e = prow[p];
      if ((e >> kTileLog) != (p >> kTileLog)) {
        x[j] = e;
        active |= 1u << j;
      }
    }
  }
  for (int steps = 0; active; ++steps) {
    if (steps > N) __trap();  // only a cycle chases longer than the row
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (active >> j & 1) {
        const int y = __ldcg(prow + x[j]);
        const int p = c0 + j * kChaseThreads;
        if (y == x[j]) {
          orow[p] = __ldg(vrow + y);
          active &= ~(1u << j);
        } else {
          x[j] = y;
          __stcg(prow + p, y);
        }
      }
    }
  }
}

}  // namespace

// parent, val, out: int32[B, N]; ptr: int32[B * N] scratch.
extern "C" int resolve_launch(const void* parent, const void* val, void* ptr,
                              void* out, int B, int N, void* stream) {
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (N + kTile - 1) / kTile;
  const long long tiles = (long long)B * ntiles;
  const int spans = (N + kSpan - 1) / kSpan;
  const long long chases = (long long)B * spans;
  if (tiles > 0x7FFFFFFF || chases > 0x7FFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  resolve_tile_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      (const int*)parent, (const int*)val, (int*)ptr, (int*)out, N, ntiles);
  if (ntiles > 1) {  // a row of one tile has no exit
    resolve_chase_kernel<<<(unsigned)chases, kChaseThreads, 0, s>>>(
        (int*)ptr, (const int*)val, (int*)out, N, spans);
  }
  return (int)cudaGetLastError();
}
