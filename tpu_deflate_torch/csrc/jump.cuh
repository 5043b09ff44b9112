// Pointer jumping over rows of device memory, for resolve.cu: ptr[b][p]
// is a position on p's parent chain, and a round
// replaces it by ptr[b][ptr[b][p]], in place, until every pointer rests on
// its chain's root (a position that points at itself).
//
// A thread may read a pointer that another thread has already advanced in
// the same round: that pointer still lies on p's chain, nearer the root,
// so the race only shortens the work and the roots reached are the same.
// A round that moves a pointer raises the flag of the next round; a round
// whose flag is down returns at once, so the launches after convergence
// cost no memory traffic and the host never has to read a flag.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kJumpThreads = 256;

inline int jump_blocks(long long total) {
  const long long want = (total + kJumpThreads - 1) / kJumpThreads;
  return (int)(want < 1 ? 1 : (want > 65535 ? 65535 : want));
}

__global__ void jump_kernel(int* ptr, int* flags, int round, long long total,
                            int N) {
  if (flags[round] == 0) return;
  volatile int* vptr = ptr;
  bool changed = false;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / N * N;
    const int p = vptr[i];
    const int q = vptr[row + p];
    if (q != p) {
      vptr[i] = q;
      changed = true;
    }
  }
  if (changed) flags[round + 1] = 1;
}

// Rounds first .. first + count - 1, reading flags[first] and raising up to
// flags[first + count].
inline void launch_jumps(int* ptr, int* flags, int first, int count,
                         long long total, int N, cudaStream_t s) {
  for (int r = first; r < first + count; ++r) {
    jump_kernel<<<jump_blocks(total), kJumpThreads, 0, s>>>(ptr, flags, r,
                                                           total, N);
  }
}

}  // namespace
