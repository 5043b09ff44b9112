// Multi-channel scatter-add: out[b, c, idx[b, e]] += vals[b, c, e], the
// encoder's bit-pack of emissions into bytes.
//
// Replaces: tpu_deflate/kernels/monotone.py, mono_scatter_add (Pallas body
// _kernel).  The TPU form paints 2048-entry slabs into an output window
// with one-hot MXU matmuls, because the TPU has no fast scatter; Hopper has
// native integer atomics.
//
// Bound on the card: memory traffic.  Each entry reads its index and C
// values once and issues at most C atomic adds.  The indices are
// nondecreasing, so neighbouring threads add into the same few cache
// lines of the output and the atomics resolve in L2.
//
// Design: one thread per entry, grid-strided over the batch.  Integer adds
// are exact and commutative, so the result does not depend on the order
// in which atomics land.  Entries whose value is 0 (the encoder's
// non-token positions) skip the add; entries outside [0, size) drop out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void mono_scatter_add_kernel(const int* __restrict__ idx,
                                        const int* __restrict__ vals,
                                        int* __restrict__ out, int B, int C,
                                        int K, int size) {
  const long long total = (long long)B * K;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(t / K);
    const int e = (int)(t - (long long)b * K);
    const int j = idx[t];
    if (j < 0 || j >= size) continue;
    for (int c = 0; c < C; ++c) {
      const int v = vals[((long long)b * C + c) * K + e];
      if (v != 0) atomicAdd(out + ((long long)b * C + c) * size + j, v);
    }
  }
}

}  // namespace

extern "C" int mono_scatter_add_launch(const void* idx, const void* vals,
                                       void* out, int B, int C, int K,
                                       int size, void* stream) {
  const int threads = 256;
  const long long total = (long long)B * K;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond 64 per SM
  mono_scatter_add_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const int*)vals, (int*)out, B, C, K, size);
  return (int)cudaGetLastError();
}
