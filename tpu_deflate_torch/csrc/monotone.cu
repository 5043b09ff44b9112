// Multi-channel scatter-add: out[b, c, j] = sum of vals[b, c, e] over the e
// with idx[b, e] == j, the encoder's bit-pack of emissions into bytes.
//
// Replaces: tpu_deflate/kernels/monotone.py, mono_scatter_add (Pallas body
// _kernel).  The TPU form paints 2048-entry slabs into an output window
// with one-hot MXU matmuls, carried from one grid step to the next.  Both
// rely on the same precondition: live indices are nondecreasing, dead
// entries carry an index < 0 (at the head) or >= size (at the tail).
//
// Bound on the card: memory traffic.  Each entry's index and C values are
// read once and each output element is written once.
//
// Design: slabs of 2048 consecutive entries of a lane.  With indices
// clamped to [-1, size], equal indices are adjacent, so the block of a
// slab owns the output elements from the one after the index before its
// slab up to its last index: exactly the indices whose first entry it
// holds, and the gaps between them that no entry names.  Two launches:
//
//   lead  one warp a slab: the sum of the slab's leading run, the entries
//         that continue the index of the entry before the slab (a search
//         for the run's end, then the warp sums it; 0 where none do).
//   pack  one block of 256 threads a slab.  A run's sum is a segmented
//         reduction with no atomics: each thread takes 8 consecutive
//         entries, a block-wide prefix sum (warp shuffles, then the warps'
//         totals in shared memory) gives every entry's running sum P, and
//         a run of entries s..e sums to P[e] - P[s - 1], the run's first
//         entry storing -P[s - 1] and its last adding P[e] into a window of
//         the owned range in shared memory.  Where the slab's last run goes
//         on past the slab, one warp finds where it ends (the next 32
//         entries, then a 32-way search over the clamped indices, which
//         are nondecreasing) and the block adds the leading sums of the
//         slabs it covers, so a run over many slabs is summed by as many
//         warps.  The window (4096 elements; more passes if the range is
//         wider) is written out with coalesced plain stores.  The elements
//         after the lane's last entry, most of the output when the data
//         compresses well, are zeros shared out evenly among the lane's
//         blocks.
//
// So every output element is written exactly once and the output needs no
// memset; a lane whose entries are all dead is all zeros.  Sums are taken
// mod 2^32, as the int32 sums of the plain version wrap.  The global loads
// are 4 bytes a thread, coalesced: the encoder's K (N + 2, 2N + 342) is
// never a multiple of 4, so its rows are not 16-byte aligned.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kPer = 8;                         // entries a thread
constexpr int kPackSlab = kPackThreads * kPer;  // entries a block
constexpr int kWindow = 4096;                   // output elements a pass
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ int clamp_key(int j, int size) {
  return j < 0 ? -1 : (j > size ? size : j);
}

// The first entry in [L, H) of a lane's indices il whose clamped index is
// not `key`, or H, given that the entries from L on that are `key` come
// first.  All 32 lanes of a warp call it: the next 32 entries, then 32
// probes a step, each the first entry of a piece of what is left.
__device__ int run_end(const int* __restrict__ il, int L, int H, int key,
                       int size) {
  const int lane = threadIdx.x & 31;
  const int p = L + lane;
  const unsigned m =
      __ballot_sync(kAll, p >= H || clamp_key(__ldg(il + p), size) != key);
  if (m) return min(L + __ffs(m) - 1, H);
  L += 32;  // [L, H) holds the end; entries before L are `key`
  while (L < H) {
    const int step = (H - L + 31) >> 5;
    const int q = L + lane * step;
    const unsigned out = __ballot_sync(
        kAll, q < H && clamp_key(__ldg(il + q), size) != key);
    const int f = out ? __ffs(out) - 1 : 32;          // first probe past it
    const int in_run = min(f - 1, (H - L - 1) / step);  // last probe in it
    if (f < 32) H = L + f * step;
    if (f > 0) L += in_run * step + 1;
  }
  return H;
}

// Inclusive prefix sum of x over the block's threads; `total` gets the sum
// over all of them.  Every thread of the block calls it.
__device__ __forceinline__ uint32_t block_scan(uint32_t x, uint32_t* part,
                                               uint32_t& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  uint32_t base = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kPackWarps; ++w) {
    base += w < warp ? part[w] : 0;
    total += part[w];
  }
  __syncthreads();  // part is free for the next call
  return base + x;
}

__global__ void __launch_bounds__(kPackThreads)
mono_scatter_add_lead_kernel(const int* __restrict__ idx,
                             const int* __restrict__ vals,
                             uint32_t* __restrict__ lead, int C, int K,
                             int size, int nslab) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kPackWarps + (threadIdx.x >> 5);  // the slab
  const int b = blockIdx.y;
  if (s >= nslab) return;
  const int* il = idx + (size_t)b * K;
  const int s0 = s * kPackSlab;
  const int before = s0 ? clamp_key(__ldg(il + s0 - 1), size) : -1;
  // a dead index's run is never summed: it has no owner
  const int e = before >= 0 && before < size
                    ? run_end(il, s0, min(s0 + kPackSlab, K), before, size)
                    : s0;
  for (int c = 0; c < C; ++c) {
    const int* vc = vals + ((size_t)b * C + c) * K;
    uint32_t t = 0;
#pragma unroll 4
    for (int i = s0 + lane; i < e; i += 32) t += (uint32_t)__ldg(vc + i);
    t = __reduce_add_sync(kAll, t);
    if (lane == 0) lead[((size_t)b * nslab + s) * C + c] = t;
  }
}

__global__ void __launch_bounds__(kPackThreads)
mono_scatter_add_kernel(const int* __restrict__ idx,
                        const int* __restrict__ vals,
                        const uint32_t* __restrict__ lead,
                        int* __restrict__ out, int C, int K, int size) {
  __shared__ __align__(16) int ks[kPackSlab + 4];  // the slab's keys
  __shared__ __align__(16) uint32_t vs[kPackSlab];
  __shared__ uint32_t acc[kWindow];
  __shared__ uint32_t part[kPackWarps];
  __shared__ int run_stop;
  const int b = blockIdx.y;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int nslab = gridDim.x;
  const int* il = idx + (size_t)b * K;
  const int* vl = vals + (size_t)b * C * K;
  int* ol = out + (size_t)b * C * size;

  // this block's share of the zeros after the lane's last entry
  const int t0 = K ? clamp_key(__ldg(il + K - 1), size) + 1 : 0;
  if (t0 < size) {
    const int share = (size - t0 + nslab - 1) / nslab;
    const int a = t0 + s * share;
    const int z = min(a + share, size);
    for (int c = 0; c < C; ++c)
      for (int j = a + tid; j < z; j += kPackThreads)
        ol[(size_t)c * size + j] = 0;
  }

  const int s0 = s * kPackSlab;
  const int n = max(0, min(kPackSlab, K - s0));  // this slab's entries
  const int before = s0 ? clamp_key(__ldg(il + s0 - 1), size) : -1;
  const int last = n ? clamp_key(__ldg(il + s0 + n - 1), size) : before;
  const int lo = before + 1;  // the owned range [lo, hi]
  const int hi = min(last, size - 1);
  if (lo > hi) return;  // every entry continues a run owned before
  for (int i = tid; i <= kPackSlab; i += kPackThreads)
    ks[i] = i < n ? clamp_key(__ldg(il + s0 + i), size) : size + 1;
  uint32_t vr[kPer];  // a channel's values, strided: entry tid + 256 u
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + kPackThreads * u;
    vr[u] = i < n ? (uint32_t)__ldg(vl + s0 + i) : 0u;
  }
  // the slab's last run goes on past the slab: the last slab it reaches
  if (tid < 32) {
    const int e = last < size && s0 + n < K ? run_end(il, s0 + n, K, last, size)
                                            : s0 + n;
    if (tid == 0) run_stop = (e - 1) / kPackSlab;
  }
  __syncthreads();
  const int s_stop = run_stop;

  int key[kPer];
  const int4* k4 = reinterpret_cast<const int4*>(ks + kPer * tid);
  const int4 ka = k4[0], kb = k4[1];
  key[0] = ka.x, key[1] = ka.y, key[2] = ka.z, key[3] = ka.w;
  key[4] = kb.x, key[5] = kb.y, key[6] = kb.z, key[7] = kb.w;
  const int prev = tid ? ks[kPer * tid - 1] : before;
  const int next = ks[kPer * tid + kPer];

  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) vs[tid + kPackThreads * u] = vr[u];
    uint32_t tail = 0;  // the run past the slab: this thread's leading sums
    for (int t = s + 1 + tid; t <= s_stop; t += kPackThreads)
      tail += __ldg(lead + ((size_t)b * nslab + t) * C + c);
    __syncthreads();
    if (c + 1 < C) {  // the next channel's values, in flight meanwhile
      const int* vc = vl + (size_t)(c + 1) * K;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = tid + kPackThreads * u;
        vr[u] = i < n ? (uint32_t)__ldg(vc + s0 + i) : 0u;
      }
    }
    uint32_t p[kPer];  // running sums over this thread's entries
    const uint4* v4 = reinterpret_cast<const uint4*>(vs + kPer * tid);
    const uint4 va = v4[0], vb = v4[1];
    p[0] = va.x, p[1] = va.y, p[2] = va.z, p[3] = va.w;
    p[4] = vb.x, p[5] = vb.y, p[6] = vb.z, p[7] = vb.w;
    const uint32_t v0 = p[0];
#pragma unroll
    for (int u = 1; u < kPer; ++u) p[u] += p[u - 1];
    uint32_t tail_sum = 0, slab_sum;
    if (s_stop > s) block_scan(tail, part, tail_sum);
    const uint32_t base = block_scan(p[kPer - 1], part, slab_sum) - p[kPer - 1];
#pragma unroll
    for (int u = 0; u < kPer; ++u) p[u] += base;
    const uint32_t p_before = p[0] - v0;  // the sum before this thread's

    for (int wlo = lo; wlo <= hi; wlo += kWindow) {
      const int w = min(kWindow, hi - wlo + 1);
      for (int j = tid; j < w; j += kPackThreads) acc[j] = 0;
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPer; ++u) {  // a run's first entry
        const int j = key[u] - wlo;
        const int left = u ? key[u - 1] : prev;
        if (j >= 0 && j < w && left != key[u]) acc[j] = -(u ? p[u - 1] : p_before);
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPer; ++u) {  // a run's last entry
        const int j = key[u] - wlo;
        const int right = u + 1 < kPer ? key[u + 1] : next;
        if (j >= 0 && j < w && right != key[u])
          acc[j] += p[u] + (kPer * tid + u == n - 1 ? tail_sum : 0u);
      }
      __syncthreads();
      int* oc = ol + (size_t)c * size + wlo;
      for (int j = tid; j < w; j += kPackThreads) oc[j] = (int)acc[j];
      __syncthreads();  // the window is free for the next pass
    }
  }
}

}  // namespace

extern "C" int mono_scatter_add_launch(const void* idx, const void* vals,
                                       void* lead, void* out, int B, int C,
                                       int K, int size, void* stream) {
  // lead: uint32[B, nslab, C] of scratch, nslab = ceil(K / 2048)
  const int nslab = K > 0 ? (K + kPackSlab - 1) / kPackSlab : 1;
  const cudaStream_t st = (cudaStream_t)stream;
  if (K > 0) {
    dim3 lgrid((nslab + kPackWarps - 1) / kPackWarps, B);
    mono_scatter_add_lead_kernel<<<lgrid, kPackThreads, 0, st>>>(
        (const int*)idx, (const int*)vals, (uint32_t*)lead, C, K, size, nslab);
  }
  mono_scatter_add_kernel<<<dim3(nslab, B), kPackThreads, 0, st>>>(
      (const int*)idx, (const int*)vals, (const uint32_t*)lead, (int*)out, C,
      K, size);
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
