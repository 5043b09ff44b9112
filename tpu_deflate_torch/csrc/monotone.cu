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

// ---------------------------------------------------------------------------
// Compaction scatter-add: out[b, c, idx[b, e]] += vals[b, c, e] for a small
// output, the decoder's code-length paint (K = 4608 entries per lane, C = 2
// channels, size 320).
//
// Replaces: tpu_deflate/kernels/monotone.py, mono_compact (Pallas body
// _compact_kernel), which paints 2048-entry slabs through one-hot bf16 MXU
// products and needs the live indices nondecreasing, advancing by at most
// one per entry.  Here the sums need no order at all.
//
// Bound on the card: bytes, and at one lane a call, launch latency.  A
// lane's indices are read once, 16 bytes a thread and load; most entries
// are dead (the paint sends the window past the header to `size`), so a
// value is read only for a live entry.
//
// Design: one block per lane.  The block zeroes a C x size accumulator in
// shared memory, every thread adds its live entries into it with shared
// integer atomics (exact in any order), and the block writes all of it
// out, so the output needs no memset.  The indices are read as int4 where
// K and the pointer allow, else one int at a time.  An accumulator above
// the default 48 KiB of dynamic shared memory fails the launch, which the
// entry point reports.
// ---------------------------------------------------------------------------

namespace {

__device__ __forceinline__ void paint(int* acc, const int* vl, int C, int K,
                                      int size, int e, int j) {
  if (j < 0 || j >= size) return;
  for (int c = 0; c < C; ++c) {
    const int v = vl[(long long)c * K + e];
    if (v != 0) atomicAdd(acc + c * size + j, v);
  }
}

__global__ void mono_compact_kernel(const int* __restrict__ idx,
                                    const int* __restrict__ vals,
                                    int* __restrict__ out, int C, int K,
                                    int size, bool vec_in) {
  extern __shared__ int acc[];  // [C][size]
  const int b = blockIdx.x;
  const int n = C * size;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc[i] = 0;
  __syncthreads();
  const int* il = idx + (long long)b * K;
  const int* vl = vals + (long long)b * C * K;
  if (vec_in) {
    const int4* i4 = reinterpret_cast<const int4*>(il);
    for (int g = threadIdx.x; g < K / 4; g += blockDim.x) {
      const int4 j = __ldg(i4 + g);
      paint(acc, vl, C, K, size, 4 * g, j.x);
      paint(acc, vl, C, K, size, 4 * g + 1, j.y);
      paint(acc, vl, C, K, size, 4 * g + 2, j.z);
      paint(acc, vl, C, K, size, 4 * g + 3, j.w);
    }
  } else {
    for (int e = threadIdx.x; e < K; e += blockDim.x)
      paint(acc, vl, C, K, size, e, __ldg(il + e));
  }
  __syncthreads();
  int* ol = out + (long long)b * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) ol[i] = acc[i];
}

}  // namespace

extern "C" int mono_compact_launch(const void* idx, const void* vals,
                                   void* out, int B, int C, int K, int size,
                                   void* stream) {
  const size_t smem = sizeof(int) * (size_t)C * size;
  const bool vec_in = K % 4 == 0 && ((uintptr_t)idx & 15) == 0;
  mono_compact_kernel<<<B, 256, smem, (cudaStream_t)stream>>>(
      (const int*)idx, (const int*)vals, (int*)out, C, K, size, vec_in);
  return (int)cudaGetLastError();
}
