// LZ77 match search for the encoder, stages 1+2 (nearest 3-byte match,
// then extension to max_match).
//
// Replaces: tpu_deflate/kernels/match2.py, match_bitplane_batch (Pallas
// bodies _match2_kernel_hybrid / _match2_kernel).  The TPU form packs the
// byte equality of 32 distances into uint32 bitplanes with lane rolls and
// sweeps the whole window.  Here a position's nearest earlier equal key is
// found through hash chains, as zlib's matcher finds it.
//
// Bound on the card: memory traffic (one read of each byte, two int32
// writes per position) or the compares the data needs: a chain step per
// earlier key of the same hash in the window, then the extension's byte
// compares.  A sweep of every distance costs `window` compares for each
// of the 40-45 % of a text's positions that have no match, and a warp runs
// as long as its slowest lane, so every warp would sweep nearly all of it.
//
// Design: one block of 256 threads (8 warps) per tile of 4096 positions
// of a lane.  The block stages the tile with its left halo (the window
// rounded up to 32, and 3 bytes, rounded to 16) and right halo (max_match
// and the word reads past it) in shared memory, 16 bytes a load (bytes
// where a piece crosses an end of the row).  Each warp owns 512 consecutive positions.  It first links
// every position of them and of the `window` positions before (rounded up
// to 32) to the nearest earlier position whose 3-byte key has the same
// 10-bit hash: 32 positions a step, in order.  The lanes of one hash in a
// step find each other through a mask a hash in shared memory, each lane
// setting its bit (a shared-memory atomicOr, uncontended unless the step's
// keys repeat) and reading the mask back; a table in shared memory gives
// the latest position of each hash before the step.  Then each lane walks
// the chain of one of the warp's positions, nearest first, to the first
// key equal to its own; the walk ends there, or where the distance passes
// the window, so it costs a step per earlier key of the same hash in the
// window (about a quarter of a step on random bytes) and the work does not
// grow with the window.  Positions are linked only where i >= 0 and i + 3 <= n, so
// bytes before the lane and at or past n are never taken.  A found match
// is extended four bytes a compare and the writes are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kTile = 4096;                 // positions per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kOwn = kTile / kWarps;        // positions a warp owns
constexpr int kHashBits = 10;
constexpr uint16_t kNone = 0xFFFF;

constexpr int round16(int x) { return (x + 15) & ~15; }

// The 4 bytes at byte offset q of the staged words.
__device__ __forceinline__ uint32_t load4(const uint32_t* w, int q) {
  return __funnelshift_r(w[q >> 2], w[(q >> 2) + 1], 8 * (q & 3));
}

__global__ void __launch_bounds__(kThreads)
match2_kernel(const uint8_t* __restrict__ data, const int* __restrict__ lens,
              int* __restrict__ dist_out, int* __restrict__ len_out, int N,
              int window, int max_match, int lhalo, int nstage) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int whalo = (window + 31) & ~31;  // linked positions before a warp's
  const int span = whalo + kOwn;
  uint32_t* sw = smem;                                           // bytes
  uint32_t* masks = smem + nstage / 4;
  uint16_t* table = reinterpret_cast<uint16_t*>(masks + kWarps * (1 << kHashBits));
  uint16_t* chain = table + kWarps * (1 << kHashBits);
  const int lane_b = blockIdx.y;
  const int x0 = blockIdx.x * kTile;
  const int lo = x0 - lhalo;  // first staged position
  const uint8_t* row = data + (size_t)lane_b * N;
  const int n = lens[lane_b];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int l = tid & 31;

  // 16 bytes a thread and load: lo is a multiple of 16, so a piece is all
  // in the row or crosses one of its ends, and then takes byte loads
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
  uint32_t* msk = masks + warp * (1 << kHashBits);
  uint16_t* tab = table + warp * (1 << kHashBits);
  uint16_t* ch = chain + warp * span;
  for (int j = l; j < (1 << kHashBits); j += 32) {
    msk[j] = 0;
    tab[j] = kNone;
  }
  __syncthreads();

  // ---- link: 32 positions a step, in order --------------------------------
  const int start = x0 + kOwn * warp - whalo;  // the warp's first linked
  for (int s = 0; s < span; s += 32) {
    const int i = start + s + l;
    const bool ok = i >= 0 && i + 3 <= n;
    const uint32_t key = load4(sw, i - lo) & 0xFFFFFFu;
    const uint32_t h = (key * 2654435761u) >> (32 - kHashBits);
    if (ok) atomicOr(msk + h, 1u << l);
    __syncwarp();
    // the lanes of this step with hash h; a lane that cannot match, alone
    const unsigned same = ok ? msk[h] : 1u << l;
    const unsigned lower = same & ((1u << l) - 1);
    const uint16_t before = ok ? tab[h] : kNone;
    ch[s + l] = !ok ? kNone : lower ? (uint16_t)(s + 31 - __clz(lower)) : before;
    __syncwarp();
    if (ok && (same >> l) == 1) {  // the latest of its hash
      tab[h] = (uint16_t)(s + l);
      msk[h] = 0;
    }
    __syncwarp();
  }

  // ---- walk, extend, write: one position a lane ---------------------------
  for (int s = whalo; s < span; s += 32) {
    const int i = start + s + l;
    if (i >= N) break;
    int d = 0;
    int length = 0;
    if (i + 3 <= n) {
      const int ji = i - lo;
      const uint32_t key = load4(sw, ji) & 0xFFFFFFu;
      for (int q = ch[s + l]; q != kNone; q = ch[q]) {
        if (s + l - q > window) break;
        if ((load4(sw, ji - (s + l - q)) & 0xFFFFFFu) == key) {
          d = s + l - q;
          break;
        }
      }
      if (d) {
        const int kmax = min(max_match, n - i);
        length = 3;
        while (length < kmax) {
          const uint32_t x = load4(sw, ji + length) ^ load4(sw, ji + length - d);
          if (x) {
            length += (__ffs(x) - 1) >> 3;
            break;
          }
          length += 4;
        }
        length = min(length, kmax);
      }
    }
    dist_out[(size_t)lane_b * N + i] = d;
    len_out[(size_t)lane_b * N + i] = length;
  }
}

}  // namespace

extern "C" int match2_launch(const void* data, const void* lens, void* dist,
                             void* length, int B, int N, int window,
                             int max_match, void* stream) {
  const int whalo = (window + 31) & ~31;
  const int lhalo = round16(whalo + 3);
  // the right halo: an extension step reads 8 bytes past the match's last
  // compared byte
  const int rhalo = round16(max_match + 8);
  const int nstage = lhalo + kTile + rhalo;
  const int span = whalo + kOwn;
  // the bytes, then each warp's masks, table and chain links
  const size_t smem =
      nstage + kWarps * ((1 << kHashBits) * (sizeof(uint32_t) + sizeof(uint16_t)) +
                         span * sizeof(uint16_t));
  static launch::DynSmem limit;
  const cudaError_t e = limit.fit(match2_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kTile - 1) / kTile, B);
  match2_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int*)lens, (int*)dist, (int*)length, N,
      window, max_match, lhalo, nstage);
  return (int)cudaGetLastError();
}
