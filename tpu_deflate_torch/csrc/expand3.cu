// Decode stage 2: tokens -> output bytes, rows up to 2^16 bytes, one thread
// block a lane.
//
// Replaces: tpu_deflate/kernels/expand3.py, expand_fused3 (Pallas body
// _exp3_kernel).  The TPU form finds each output byte's owning token by
// one-hot matmuls and a binary search, and resolves back-references by
// pointer doubling over the whole row in VMEM, because it cannot scatter.
// The card can scatter, so the owner search goes away: each token writes
// its own bytes' parents.
//
// Bound on the card: bytes.  The tokens are read once (12 bytes each) and
// the row written once; everything between lives in the block's shared
// memory.  What stands between the kernel and that bound is work inside
// the block: one pass over the row to seed it, the scatter, a few rounds
// of pointer jumping over the row, and the gather.  Lanes are independent,
// one block each, so a batch of 128 lanes fills the card's 132 SMs.
//
// Design: the row's bytes and a 16-bit parent per byte (out_cap <= 2^16)
// sit in dynamic shared memory, 3 * out_cap bytes, sized from out_cap, so
// small rows put several blocks on an SM.
//   1. Seed: every byte below the lane's total is a root of value 0.
//   2. Scatter: the threads take the tokens in turn, reading them
//      coalesced; a token's bytes run from its offset to the next token's
//      (to the total for the last), cut at the row.  Literal and stored
//      bytes are roots and carry their value (a stored byte reads the
//      input row); byte j of a match at offset o with distance d points at
//      o - d + (j mod d), which lies before o whatever the overlap, so a
//      run of any length is one step deep.  A source before the row is
//      byte 0, as in the plain version and the JAX package; a match of
//      distance 0 leaves its bytes roots of value 0.  A token longer than
//      kLong bytes (a stored block may be the whole row) goes to a queue
//      and is written by a whole warp after the others, so no thread is
//      left with thousands of bytes.  Tokens whose offset is at or past the
//      row are ignored.
//   3. Resolve: pointer jumping in place, two parents a thread at a time,
//      until a round changes nothing (__syncthreads_or).  A thread may read
//      a parent that another thread moved in the same round; it still lies
//      on the chain, nearer the root, so the roots reached are the same.
//      A chain as deep as the row (a distance-1 run of 2^16 bytes) ends
//      within 17 rounds.
//   4. Write: each byte takes its root's value, zero past the total, in
//      16-byte stores where the row's width allows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLit = 0, kMatch = 1, kStored = 2;
constexpr int kLong = 32;  // a token longer than this is written by a warp
// at most 2^16 / (kLong + 1) tokens are longer than kLong within a row
constexpr int kQueue = 2048;

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }

struct Token {
  int o, len, kind, value, d;
};

// Token i of the lane, cut to the bytes below tot; len <= 0 for a token
// with no bytes there.
__device__ __forceinline__ Token token_at(const int* offl, const int* c1l,
                                          const int* tbl, int i, int ntok,
                                          int tot) {
  Token t;
  t.o = offl[i];
  const int nxt = i + 1 < ntok ? offl[i + 1] : tot;
  t.len = (t.o < 0 || t.o >= tot) ? 0 : min(nxt, tot) - t.o;
  const int c = c1l[i];
  t.kind = (c >> 9) & 3;
  t.value = c & 0xFF;
  t.d = tbl[i];
  return t;
}

// Byte j of token t: its parent, or its value where it is a root.
__device__ __forceinline__ void put(const Token& t, int j, int jmod,
                                    uint16_t* par, uint8_t* val,
                                    const uint8_t* row, int M) {
  const int p = t.o + j;
  if (t.kind == kLit) {
    val[p] = (uint8_t)t.value;
  } else if (t.kind == kMatch) {
    if (t.d > 0) par[p] = (uint16_t)max(t.o - t.d + jmod, 0);
  } else if (t.kind == kStored) {
    const long long s = (long long)t.d + j;
    val[p] = __ldg(row + (s < 0 ? 0 : (s < M ? s : M - 1)));
  }
}

__global__ void __launch_bounds__(kThreads) expand3_kernel(
    const uint8_t* __restrict__ rows, const int* __restrict__ off,
    const int* __restrict__ c1, const int* __restrict__ tb,
    const int* __restrict__ tp, const int* __restrict__ total,
    uint8_t* __restrict__ out, int K, int M, int out_cap) {
  extern __shared__ uint4 smem4[];
  __shared__ int queue[kQueue];
  __shared__ int nlong;
  uint16_t* par = (uint16_t*)smem4;
  uint8_t* val = (uint8_t*)smem4 + 2 * pad16(out_cap);

  const int lane = blockIdx.x, tid = threadIdx.x;
  const int ntok = min(max(tp[lane], 0), K);
  const int tot = min(max(total[lane], 0), out_cap);
  const int* offl = off + (size_t)lane * K;
  const int* c1l = c1 + (size_t)lane * K;
  const int* tbl = tb + (size_t)lane * K;
  const uint8_t* row = rows + (size_t)lane * M;

  // 1. seed: two parents and two values a thread at a time
  uint32_t* par2 = (uint32_t*)par;
  const int words = (tot + 1) >> 1;
  for (int k = tid; k < words; k += kThreads) {
    par2[k] = (uint32_t)(2 * k) | (uint32_t)(2 * k + 1) << 16;
    ((uint16_t*)val)[k] = 0;
  }
  if (tid == 0) nlong = 0;
  __syncthreads();

  // 2. scatter: short tokens a thread each, long ones queued for a warp
  for (int i = tid; i < ntok; i += kThreads) {
    const Token t = token_at(offl, c1l, tbl, i, ntok, tot);
    if (t.len <= 0) continue;
    if (t.len > kLong) {
      const int q = atomicAdd(&nlong, 1);
      if (q < kQueue) {  // always, where token offsets do not decrease
        queue[q] = i;
        continue;
      }
    }
    int jmod = 0;  // j mod d, kept without a division
    for (int j = 0; j < t.len; ++j) {
      put(t, j, jmod, par, val, row, M);
      if (++jmod == t.d) jmod = 0;
    }
  }
  __syncthreads();
  const int warp = tid >> 5, lane32 = tid & 31;
  for (int q = warp; q < min(nlong, kQueue); q += kWarps) {
    const Token t = token_at(offl, c1l, tbl, queue[q], ntok, tot);
    for (int j = lane32; j < t.len; j += 32) {
      put(t, j, t.d > 0 ? j % t.d : 0, par, val, row, M);
    }
  }
  __syncthreads();

  // 3. resolve: pointer jumping in place until nothing moves
  while (true) {
    bool moved = false;
    for (int k = tid; k < words; k += kThreads) {
      const uint32_t u = par2[k];
      const uint32_t q0 = u & 0xFFFF, q1 = u >> 16;
      const uint32_t r0 = par[q0], r1 = par[q1];
      if (r0 != q0 || r1 != q1) {
        par2[k] = r0 | r1 << 16;
        moved = true;
      }
    }
    if (!__syncthreads_or(moved)) break;
  }

  // 4. write: each byte its root's value, zero past the total
  uint8_t* outl = out + (size_t)lane * out_cap;
  if ((out_cap & 15) == 0) {
    for (int c = tid; c < out_cap / 16; c += kThreads) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t x = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = 16 * c + 4 * k + b;
          if (p < tot) x |= (uint32_t)val[par[p]] << (8 * b);
        }
        w[k] = x;
      }
      ((uint4*)outl)[c] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int p = tid; p < out_cap; p += kThreads) {
      outl[p] = p < tot ? val[par[p]] : 0;
    }
  }
}

}  // namespace

extern "C" int expand3_launch(const void* rows, const void* off,
                              const void* c1, const void* tb, const void* tp,
                              const void* total, void* out, int B, int K,
                              int M, int out_cap, void* stream) {
  // the parents and the bytes of one row, in dynamic shared memory beside
  // the kernel's static queue
  static launch::DynSmem limit;
  const int smem = 3 * pad16(out_cap);
  const cudaError_t e = limit.fit(expand3_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  expand3_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const int*)off, (const int*)c1, (const int*)tb,
      (const int*)tp, (const int*)total, (uint8_t*)out, K, M, out_cap);
  return (int)cudaGetLastError();
}
