// The exact far matcher of the full-window encode (window > 256,
// far_matcher="exact"): for every position of a lane, six LZ77 candidates
// (the 4 most recent earlier occurrences of its 3-byte key and the most
// recent of its hashed 6- and 10-byte keys), each validated (distance in
// [1, window], equal 3-byte key) and probed to 16 bytes, the longest kept
// with nearer distances winning ties, the winner extended to max_match;
// lengths clipped at n.  The output of ops/encode.py's
// _match_candidates_multi (the plain version), as int32.
//
// Replaces no Pallas kernel: the JAX package's _match_candidates_multi
// (tpu_deflate/ops/encode.py) is jnp glue, which XLA fuses on the TPU.
// Its line-for-line port in torch is about 1400 launches a call, each
// reading or writing 64-192 MiB of int64 intermediates: 72 ms on the card
// for 128 lanes of 64 KiB.
//
// Bound on the card: memory traffic.  The job needs each byte read once
// and a distance and a length written a position (9 bytes a position).
// Finding each key's previous occurrence is a sort, and a sort cannot be
// done in one pass; the design keeps every other step out of device
// memory and every intermediate in 32 bits:
//   1. farmatch_keys_kernel: one thread a position computes its 3-byte key
//      and the two multiplicative hashes in uint32 registers from the
//      bytes, one pass (12 bytes written a position).
//   2. torch.sort of the [3 B, N] keys, stable (the JAX package leaves its
//      sort to XLA too): equal keys end adjacent, in position order.
//   3. farmatch_prev_kernel: each sorted entry writes its position's
//      previous occurrence, the entry before it where the keys are equal
//      (16 bytes read and 4 written a key).
//   4. farmatch_kernel: one block of 256 threads a tile of 4096 positions
//      of a lane.  The block stages the tile's bytes in shared memory with
//      the window before it and max_match + 8 after it (37 KB at window
//      32768), 16 bytes a load.  A thread takes positions 256 apart, so
//      its reads of the previous occurrences and its writes are
//      coalesced.  The 3-byte chain follows prev3 through the read-only
//      path (its links lie within the window of the tile, which L1 and L2
//      hold), and stops at the first link past the window: the chain only
//      grows farther, so those candidates fail validation anyway.  Each
//      probe and the extension compare 4 bytes at a time from shared
//      memory (two words, a funnel shift, the first differing byte by the
//      lowest set bit), so no candidate touches device memory.
// A lane's previous occurrences are positions of that lane: 32-bit
// indices throughout, the row's base pointer formed once a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kTile = 4096;  // positions a block of farmatch_kernel matches
constexpr int kThreads = 256;
constexpr int kDepth = 4;    // occurrences of the 3-byte key tried
constexpr int kProbe = 16;   // bytes each candidate is probed to
constexpr uint32_t kHashMul = 0x9E3779B1u;

constexpr int round16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ uint32_t mix(uint32_t acc) {
  return (acc ^ (acc >> 15)) & 0x7FFFFFFFu;
}

__global__ void __launch_bounds__(kThreads)
farmatch_keys_kernel(const uint8_t* __restrict__ data,
                     const int* __restrict__ lens, int* __restrict__ keys,
                     int B, int N) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  const uint8_t* row = data + (size_t)b * N;
  const int n = lens[b];
  // bytes past the row read as zero; a key they enter is replaced by its
  // sentinel, since the key then crosses n
  uint32_t acc = 0, key3 = 0, h6 = 0;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const uint32_t x = i + k < N ? __ldg(row + i + k) : 0u;
    acc = acc * kHashMul + x;
    if (k < 3) key3 |= x << (8 * k);
    if (k == 5) h6 = mix(acc);
  }
  const size_t plane = (size_t)B * N;
  int* out = keys + (size_t)b * N + i;
  // a key that crosses n gets a value no other position has
  out[0] = i + 3 <= n ? (int)key3 : (1 << 24) + i;
  out[plane] = i + 6 <= n ? (int)h6 : -(i + 2);
  out[2 * plane] = i + 10 <= n ? (int)mix(acc) : -(i + 2);
}

__global__ void __launch_bounds__(kThreads)
farmatch_prev_kernel(const int* __restrict__ sorted,
                     const int64_t* __restrict__ order, int* __restrict__ prev,
                     long long total, int N) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long base = t - t % N;  // the row's first entry
  const bool same = t > base && sorted[t] == sorted[t - 1];
  prev[base + order[t]] = same ? (int)order[t - 1] : -1;
}

// The 4 bytes at byte offset q of the staged words.
__device__ __forceinline__ uint32_t load4(const uint32_t* w, int q) {
  return __funnelshift_r(w[q >> 2], w[(q >> 2) + 1], 8 * (q & 3));
}

// The first k in [from, kmax) at which the bytes at ji + k and ji + k - d
// differ, else kmax; the bytes before `from` are known equal.
__device__ __forceinline__ int common(const uint32_t* sw, int ji, int d,
                                      int from, int kmax) {
  int L = from;
  while (L < kmax) {
    const uint32_t x = load4(sw, ji + L) ^ load4(sw, ji + L - d);
    if (x) {
      L += (__ffs(x) - 1) >> 3;
      break;
    }
    L += 4;
  }
  return min(L, kmax);
}

__global__ void __launch_bounds__(kThreads)
farmatch_kernel(const uint8_t* __restrict__ data, const int* __restrict__ lens,
                const int* __restrict__ prev, int* __restrict__ dist_out,
                int* __restrict__ len_out, int B, int N, int window,
                int max_match, int lhalo, int nstage) {
  extern __shared__ __align__(16) uint32_t sw[];
  const int lane_b = blockIdx.y;
  const int x0 = blockIdx.x * kTile;
  const int lo = x0 - lhalo;  // first staged position, a multiple of 16
  const uint8_t* row = data + (size_t)lane_b * N;
  const int n = lens[lane_b];
  const int tid = threadIdx.x;

  // 16 bytes a thread and load; a piece that crosses an end of the row
  // takes byte loads, zero outside it
  const bool aligned = ((uintptr_t)row & 15) == 0;
  uint4* s4 = reinterpret_cast<uint4*>(sw);
  for (int j = tid; j < nstage / 16; j += kThreads) {
    const int p = lo + 16 * j;
    if (aligned && p >= 0 && p + 16 <= N) {
      s4[j] = __ldg(reinterpret_cast<const uint4*>(row + p));
    } else {
      uint8_t* sb = reinterpret_cast<uint8_t*>(s4 + j);
      for (int k = 0; k < 16; ++k)
        sb[k] = (p + k >= 0 && p + k < N) ? row[p + k] : 0;
    }
  }
  __syncthreads();

  const size_t plane = (size_t)B * N;
  const int* prev3 = prev + (size_t)lane_b * N;
  const int* prev6 = prev3 + plane;
  const int* prev10 = prev6 + plane;
  const int probe = min(kProbe, max_match);
  for (int r = tid; r < kTile; r += kThreads) {
    const int i = x0 + r;
    if (i >= N) break;
    int best_d = 0;
    int best_len = 0;
    if (i + 3 <= n) {
      const int ji = i - lo;
      const uint32_t key = load4(sw, ji) & 0xFFFFFFu;
      const int kmax = min(probe, n - i);
      // a candidate at c < i, within the window: its 3 bytes equal, then
      // the probe; the longest wins, the nearer among equal lengths
      auto consider = [&](int c) {
        const int d = i - c;
        if ((load4(sw, ji - d) & 0xFFFFFFu) != key) return;
        const int L = common(sw, ji, d, 3, kmax);
        if (L > best_len || (L == best_len && d < best_d)) {
          best_len = L;
          best_d = d;
        }
      };
      int c = __ldg(prev3 + i);
      for (int k = 0; k < kDepth && c >= 0 && i - c <= window; ++k) {
        consider(c);
        if (k + 1 < kDepth) c = __ldg(prev3 + c);
      }
      c = __ldg(prev6 + i);
      if (c >= 0 && i - c <= window) consider(c);
      c = __ldg(prev10 + i);
      if (c >= 0 && i - c <= window) consider(c);
      // the winner alone extends past the probe
      if (max_match > probe && best_len == probe)
        best_len = common(sw, ji, best_d, probe, min(max_match, n - i));
    }
    dist_out[(size_t)lane_b * N + i] = best_d;
    len_out[(size_t)lane_b * N + i] = best_len;
  }
}

}  // namespace

extern "C" int farmatch_keys_launch(const void* data, const void* lens,
                                    void* keys, int B, int N, void* stream) {
  dim3 grid((N + kThreads - 1) / kThreads, B);
  farmatch_keys_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int*)lens, (int*)keys, B, N);
  return (int)cudaGetLastError();
}

extern "C" int farmatch_prev_launch(const void* sorted, const void* order,
                                    void* prev, int rows, int N, void* stream) {
  const long long total = (long long)rows * N;
  const long long blocks = (total + kThreads - 1) / kThreads;
  farmatch_prev_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)sorted, (const int64_t*)order, (int*)prev, total, N);
  return (int)cudaGetLastError();
}

extern "C" int farmatch_launch(const void* data, const void* lens,
                               const void* prev, void* dist, void* length,
                               int B, int N, int window, int max_match,
                               void* stream) {
  // the left halo holds the window (a candidate's 3 bytes and its probe's
  // source side lie after i - window); the right halo the extension's
  // word reads, 8 bytes past the last compared byte
  const int lhalo = round16(window);
  const int nstage = lhalo + kTile + round16(max_match + 8);
  static launch::DynSmem limit;
  const cudaError_t e = limit.fit(farmatch_kernel, nstage);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kTile - 1) / kTile, B);
  farmatch_kernel<<<grid, kThreads, nstage, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int*)lens, (const int*)prev, (int*)dist,
      (int*)length, B, N, window, max_match, lhalo, nstage);
  return (int)cudaGetLastError();
}
