// Decode stage 2 for long rows: tokens -> output bytes, out_cap up to
// 2^20, any distance up to the RFC window.
//
// Replaces: tpu_deflate/kernels/expand2.py, expand_fused2 (Pallas body
// _exp2_kernel).  The TPU form paints 2048-byte output tiles with one-hot
// products, forward-fills owner keys, collapses constant-distance runs so
// that every parent lies within max_dist of its tile, and resolves by
// pointer doubling inside that window, because it cannot scatter or
// gather.  Here a thread gathers directly, so there is no window
// parameter: a match may reach any distance back.
//
// Bound on the card: bytes.  One read of the live tokens (12 bytes each)
// and one write of the row; on top of that the kernel moves a 4-byte
// pointer for each output byte, once for each round of the resolution.
// A single stream is one lane, so the work is spread over the output
// bytes, not over the lanes: a 512 KiB segment fills the card.
//
// Design: one thread for each output byte, in three steps that one call
// enqueues without a host read.
//   1. Owner and parent.  A binary search over the lane's token offsets
//      finds the token that owns byte p (the last live one whose offset
//      is at or before p).  A literal's byte is written at once and points
//      at itself.  Byte p of a match at offset o with distance d points at
//      byte o - d + ((p - o) mod d), which lies before o whatever the
//      overlap, so a run of any length is one step deep, not one step a
//      byte.  A source before the row's start is byte 0, as in the plain
//      version and the JAX package; a match of distance 0 reads zero; stored
//      tokens are not this kernel's and leave zeros (callers send such
//      batches through resolve_roots); bytes at and past the lane's total
//      are zero.
//   2. Pointer jumping (jump.cuh) until every match byte points at a
//      literal: about log2 of the deepest nesting of matches in rounds,
//      and a chain as deep as the row (a distance-1 run built from 4064
//      matches of 258) still ends within log2(out_cap) rounds.
//   3. Each match byte copies its root's byte.  Roots are never match
//      bytes, so the copy can run in place.

#include <cuda_runtime.h>
#include <stdint.h>

#include "jump.cuh"

namespace {

constexpr int kLit = 0;
constexpr int kMatch = 1;

__global__ void expand2_owner_kernel(
    const int* __restrict__ off, const int* __restrict__ c1,
    const int* __restrict__ tb, const int* __restrict__ tp,
    const int* __restrict__ total, uint8_t* __restrict__ out,
    int* __restrict__ ptr, int* __restrict__ flags, long long cells, int K,
    int out_cap) {
  bool any_match = false;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < cells; i += (long long)gridDim.x * blockDim.x) {
    const int lane = (int)(i / out_cap);
    const int p = (int)(i - (long long)lane * out_cap);
    const int ntok = min(max(tp[lane], 0), K);
    const int tot = min(max(total[lane], 0), out_cap);
    const int* offl = off + (size_t)lane * K;
    int self = p;
    uint8_t byte = 0;
    if (p < tot && ntok > 0 && offl[0] <= p) {
      int lo = 0, hi = ntok;  // offl[lo] <= p < offl[hi], hi == ntok: none
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (offl[mid] <= p) lo = mid; else hi = mid;
      }
      const int c = c1[(size_t)lane * K + lo];
      const int kind = (c >> 9) & 3;
      if (kind == kLit) {
        byte = (uint8_t)(c & 0xFF);
      } else if (kind == kMatch) {
        const int o = offl[lo];
        const int d = tb[(size_t)lane * K + lo];
        if (d > 0) {  // a source before the row is the row's byte 0
          self = max(o - d + (p - o) % d, 0);
          any_match = true;
        }
      }
    }
    out[i] = byte;
    ptr[i] = self;
  }
  if (any_match) flags[0] = 1;
}

__global__ void expand2_pick_kernel(const int* __restrict__ ptr,
                                    uint8_t* out, long long cells,
                                    int out_cap) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < cells; i += (long long)gridDim.x * blockDim.x) {
    const int p = (int)(i % out_cap);
    const int root = ptr[i];
    if (root != p) out[i] = out[i - p + root];
  }
}

}  // namespace

// flags: int[rounds + 1], zeroed by the caller; ptr: int[B * out_cap]
// scratch.
extern "C" int expand2_launch(const void* off, const void* c1, const void* tb,
                              const void* tp, const void* total, void* out,
                              void* ptr, void* flags, int B, int K,
                              int out_cap, int rounds, void* stream) {
  const long long cells = (long long)B * out_cap;
  const int blocks = jump_blocks(cells);
  cudaStream_t s = (cudaStream_t)stream;
  expand2_owner_kernel<<<blocks, kJumpThreads, 0, s>>>(
      (const int*)off, (const int*)c1, (const int*)tb, (const int*)tp,
      (const int*)total, (uint8_t*)out, (int*)ptr, (int*)flags, cells, K,
      out_cap);
  launch_jumps((int*)ptr, (int*)flags, 0, rounds, cells, out_cap, s);
  expand2_pick_kernel<<<blocks, kJumpThreads, 0, s>>>(
      (const int*)ptr, (uint8_t*)out, cells, out_cap);
  return (int)cudaGetLastError();
}
