// Decode stage 2: tokens -> output bytes, one lane per block.
//
// Replaces: tpu_deflate/kernels/expand3.py, expand_fused3 (Pallas body
// _exp3_kernel).  The TPU form finds each output byte's owning token by
// one-hot matmuls and a binary search, and resolves back-references by
// pointer doubling over the whole row, because it cannot scatter; here a
// warp writes each token's bytes where they go.
//
// Bound on the card: the token walk.  A lane's tokens are processed in
// stream order, so a lane is one warp stepping through ~40k tokens of a
// 64 KiB chunk; with one lane per SM the card is latency-bound, not
// bandwidth-bound (one read of the tokens, one write of the output).
//
// Design: the lane's output row lives in shared memory (out_cap <= 64 KiB).
// The warp loads 32 tokens at a time, one per thread, coalesced.  Their
// literals have no dependencies and are written at once.  Then the matches
// and stored blocks of the group are copied in stream order, each by the
// whole warp: byte j of a match at offset o with distance d equals byte
// o - d + (j mod d), which lies before o and is final, so every byte of
// the match is copied in the same step whatever the overlap (d < length).
// Stored blocks copy from the input row.  The row goes to device memory
// at the end, zero past the lane's total.  A token reaching before the
// output start (which the tokenizer reports as ERR_DIST) reads zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kLit = 0;
constexpr int kMatch = 1;

__global__ void expand3_kernel(const uint8_t* __restrict__ rows,
                               const int* __restrict__ off,
                               const int* __restrict__ c1,
                               const int* __restrict__ tb,
                               const int* __restrict__ tp,
                               const int* __restrict__ total,
                               uint8_t* __restrict__ out, int K, int M,
                               int out_cap) {
  extern __shared__ uint8_t buf[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const int ntok = tp[lane];
  const int tot = total[lane];
  const int* offl = off + (size_t)lane * K;
  const int* c1l = c1 + (size_t)lane * K;
  const int* tbl = tb + (size_t)lane * K;
  const uint8_t* row = rows + (size_t)lane * M;

  for (int i = t; i < out_cap; i += kWarp) buf[i] = 0;
  __syncwarp();

  for (int g = 0; g < ntok; g += kWarp) {
    const int i = g + t;
    const bool have = i < ntok;
    const int o = have ? offl[i] : 0;
    const int c = have ? c1l[i] : 0;
    const int d = have ? tbl[i] : 0;
    const int nxt = !have ? 0 : (i + 1 < ntok ? offl[i + 1] : tot);
    const int kind = (c >> 9) & 3;
    if (have && kind == kLit && o >= 0 && o < out_cap) buf[o] = c & 0xFF;
    __syncwarp();
    unsigned pending = __ballot_sync(kFull, have && kind != kLit);
    while (pending) {
      const int src = __ffs(pending) - 1;
      pending &= pending - 1;
      const int so = __shfl_sync(kFull, o, src);
      const int sd = __shfl_sync(kFull, d, src);
      const int sk = __shfl_sync(kFull, kind, src);
      const int len = __shfl_sync(kFull, nxt, src) - so;
      const int lim = so < 0 ? 0 : min(len, out_cap - so);
      if (sk == kMatch) {
        for (int j = t; j < lim; j += kWarp) {
          const int s = sd > 0 ? so - sd + j % sd : -1;
          buf[so + j] = s >= 0 ? buf[s] : 0;
        }
      } else {
        for (int j = t; j < lim; j += kWarp) {
          const long long s = (long long)sd + j;
          buf[so + j] = row[s < M ? (s < 0 ? 0 : s) : M - 1];
        }
      }
      __syncwarp();
    }
  }

  uint8_t* outl = out + (size_t)lane * out_cap;
  for (int i = t; i < out_cap; i += kWarp) outl[i] = i < tot ? buf[i] : 0;
}

}  // namespace

extern "C" int expand3_launch(const void* rows, const void* off,
                              const void* c1, const void* tb, const void* tp,
                              const void* total, void* out, int B, int K,
                              int M, int out_cap, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      expand3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out_cap);
  if (e != cudaSuccess) return (int)e;
  expand3_kernel<<<B, kWarp, out_cap, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const int*)off, (const int*)c1, (const int*)tb,
      (const int*)tp, (const int*)total, (uint8_t*)out, K, M, out_cap);
  return (int)cudaGetLastError();
}
