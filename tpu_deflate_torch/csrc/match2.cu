// LZ77 match search for the encoder, stages 1+2 (nearest 3-byte match,
// then extension to max_match).
//
// Replaces: tpu_deflate/kernels/match2.py, match_bitplane_batch (Pallas
// bodies _match2_kernel_hybrid / _match2_kernel).  The TPU form packs
// byte-equality planes of 32 distances into uint32 bitplanes with lane
// rolls, because the TPU has no cheap gathers; here every thread reads
// its window from shared memory directly.
//
// Bound on the card: compare work.  A position with no match within the
// window costs `window` key compares; a compressible position stops at its
// nearest match, usually within a few distances.  Device-memory traffic is
// one read of each byte and two int32 writes per position.
//
// Design: one thread per position, 256 positions per block, one lane per
// grid row.  The block stages its segment with a `window`-byte left halo
// and a `max_match`-byte right halo in shared memory, and precomputes each
// staged position's 3-byte key, so the distance loop is one shared-memory
// read and one compare per distance.  Bytes before the lane never match
// (d <= i); bytes at or past n are never compared (i + 3 <= n for a seed,
// i + k < n for an extension step).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void match2_kernel(const uint8_t* __restrict__ data,
                              const int* __restrict__ lens,
                              int* __restrict__ dist_out,
                              int* __restrict__ len_out,
                              int N, int window, int max_match) {
  extern __shared__ uint32_t smem[];
  const int lane = blockIdx.y;
  const int x0 = blockIdx.x * kThreads;
  const int lo = x0 - window;                      // first staged position
  const int nkeys = window + kThreads;             // keys for [lo, x0 + T)
  const int nbytes = nkeys + max_match + 2;        // bytes for [lo, ...)
  uint32_t* keys = smem;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem + nkeys);
  const uint8_t* row = data + (size_t)lane * N;
  const int n = lens[lane];

  for (int j = threadIdx.x; j < nbytes; j += kThreads) {
    const int p = lo + j;
    bytes[j] = (p >= 0 && p < N) ? row[p] : 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nkeys; j += kThreads) {
    keys[j] = bytes[j] | (bytes[j + 1] << 8) | (bytes[j + 2] << 16);
  }
  __syncthreads();

  const int i = x0 + threadIdx.x;
  if (i >= N) return;
  int best = 0;
  int length = 0;
  if (i + 3 <= n) {
    const int ji = i - lo;                         // staged index of i
    const uint32_t key = keys[ji];
    const int dmax = min(window, i);
    for (int d = 1; d <= dmax; ++d) {
      if (keys[ji - d] == key) {
        best = d;
        break;
      }
    }
    if (best) {
      length = 3;
      const int kmax = min(max_match, n - i);
      while (length < kmax && bytes[ji + length] == bytes[ji + length - best]) {
        ++length;
      }
    }
  }
  dist_out[(size_t)lane * N + i] = best;
  len_out[(size_t)lane * N + i] = length;
}

}  // namespace

extern "C" int match2_launch(const void* data, const void* lens, void* dist,
                             void* length, int B, int N, int window,
                             int max_match, void* stream) {
  const int nkeys = window + kThreads;
  const size_t smem = nkeys * sizeof(uint32_t) + nkeys + max_match + 2;
  dim3 grid((N + kThreads - 1) / kThreads, B);
  match2_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int*)lens, (int*)dist, (int*)length, N,
      window, max_match);
  return (int)cudaGetLastError();
}
