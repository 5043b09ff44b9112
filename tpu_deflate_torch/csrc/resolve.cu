// Back-reference resolution: the value at the root of each output
// position's parent chain.
//
// Replaces: tpu_deflate/kernels/resolve.py, resolve_roots (Pallas body
// _resolve_kernel).  The TPU form gathers parent[parent[p]] with one-hot
// products on the matrix unit, over byte planes that stay exact in bf16,
// which limits a row to 2^16 positions and the kernel to 8 rounds with an
// XLA finisher.  Here a thread reads parent[p] directly, so a row may have
// any length and the rounds go on until every chain has reached its root.
//
// Bound on the card: bytes.  One read of parent and val and one write of
// the result, 12 bytes a position; each further round reads and writes the
// 4-byte pointer array again, and there are about log2(depth) rounds for
// the deepest chain (a distance-1 run of 500 KiB is 2^19 deep).
//
// Design: pointer jumping in rounds over device memory (jump.cuh), one
// launch a round, all enqueued by one call without a host read.  The first
// launch writes ptr[p] = parent[parent[p]] into scratch, the rounds jump in
// place, and the last launch writes out[p] = val[ptr[p]].  Parents are
// clamped into the row, so a malformed input reads no memory outside it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "jump.cuh"

namespace {

__device__ __forceinline__ int clamp_idx(int p, int N) {
  return p < 0 ? 0 : (p >= N ? N - 1 : p);
}

// ptr[p] = parent[parent[p]], row by row; raises flags[1] if any pointer
// moved past its parent.
__global__ void resolve_first_kernel(const int* __restrict__ parent,
                                     int* __restrict__ ptr,
                                     int* __restrict__ flags, long long total,
                                     int N) {
  bool changed = false;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / N * N;
    const int p = clamp_idx(parent[i], N);
    const int q = clamp_idx(parent[row + p], N);
    ptr[i] = q;
    changed |= q != p;
  }
  if (changed) flags[1] = 1;
}

__global__ void resolve_pick_kernel(const int* __restrict__ ptr,
                                    const int* __restrict__ val,
                                    int* __restrict__ out, long long total,
                                    int N) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    out[i] = val[i / N * N + ptr[i]];
  }
}

}  // namespace

// flags: int[rounds + 2], zeroed by the caller; ptr: int[B * N] scratch.
extern "C" int resolve_launch(const void* parent, const void* val, void* ptr,
                              void* flags, void* out, int B, int N,
                              int rounds, void* stream) {
  const long long total = (long long)B * N;
  const int blocks = jump_blocks(total);
  cudaStream_t s = (cudaStream_t)stream;
  resolve_first_kernel<<<blocks, kJumpThreads, 0, s>>>(
      (const int*)parent, (int*)ptr, (int*)flags, total, N);
  launch_jumps((int*)ptr, (int*)flags, 1, rounds, total, N, s);
  resolve_pick_kernel<<<blocks, kJumpThreads, 0, s>>>(
      (const int*)ptr, (const int*)val, (int*)out, total, N);
  return (int)cudaGetLastError();
}
