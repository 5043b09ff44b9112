// Decode stage 2 for long rows: tokens -> output bytes, out_cap up to
// 2^20, any distance up to the RFC window.
//
// Replaces: tpu_deflate/kernels/expand2.py, expand_fused2 (Pallas body
// _exp2_kernel).  The TPU form paints 2048-byte output tiles with one-hot
// products, forward-fills owner keys, collapses constant-distance runs so
// that every parent lies within max_dist of its tile, and resolves by
// pointer doubling inside that window, because it cannot scatter or
// gather.  Here a block gathers directly, so there is no window
// parameter: a match may reach any distance back.
//
// Bound on the card: bytes: one read of the live tokens (12 bytes each)
// and one write of the row.  Every match source lies at least one byte
// back, so the work has an order, and a row whose every tile copies from
// the tile before it (a distance-1 run) is a chain as long as the row;
// the design below walks such a chain one tile a step, a read through L2
// each, not one handoff of finished bytes a tile.
//
// Design: a block expands one output tile of kTile bytes, all in one
// launch (beside a memset of the tickets and flags).
//   1. Ticket.  A block takes its (lane, tile) from an atomic ticket
//      counter, tile-major, so the lanes of a batch run side by side.
//   2. Tokens.  A block-wide search (a probe a thread a round) finds the owners
//      of the tile's first and last live bytes: the last token whose offset
//      is at or before the byte (offsets do not decrease).  Each token that
//      starts inside the tile writes its index at its start; a max-scan
//      gives every byte its owner.
//   3. Parents, in shared memory.  A literal byte is a root with its value.
//      Byte p of a match at offset o with distance d points at
//      o - d + ((p - o) mod d), which lies before o whatever the overlap,
//      so a run of any length is one step deep.  A source before the row
//      is byte 0, as in the plain version and the JAX package; a match of
//      distance 0 reads zero; stored tokens are not this kernel's and leave
//      zeros (callers send such batches through resolve_roots); bytes at
//      and past the lane's total are zero.  A parent inside the tile is a
//      local index; one in an earlier tile is kept as that byte's position
//      in the row ("external").
//   4. In-tile chains.  Pointer jumping in shared memory until a round
//      moves nothing; a chain then ends at a local root or at an external
//      byte, whose value is that of the byte it names.
//   5. Publish.  Each live byte's entry goes to the lane's chain table in
//      device memory: its value where its chain ended in the tile, else
//      the external position.  Then the tile's flag is raised.  No tile
//      waits for another before it publishes.
//   6. Wait until the lane's tiles up to the highest one the tile's
//      external bytes name have published.
//   7. Chase.  An external byte follows the published entries, each step
//      into an earlier tile, until one holds a value; the value is written
//      back over the byte's own entry, so a later chase through it stops
//      there.  The tile is written in 16-byte stores.
//
// Trouble spots:
//   - Deadlock.  A block waits only on tiles of lower tickets, and a
//     ticket is taken by a block that is already running; a tile publishes
//     before it waits on any other, so whatever the grid size and
//     residency the tiles waited on publish.  A wait that outlasts
//     kMaxPolls polls traps: a fault becomes a launch error, never a hung
//     card.
//   - Memory ordering.  A tile's entries are published by a barrier, then
//     one thread's release store of its flag (st.release.gpu, cumulative
//     over the stores the barrier ordered before it); a waiter polls with
//     an acquire load (ld.acquire.gpu) before a barrier, and the chase
//     reads entries through L2 (ld.global.cg), never through the
//     read-only path or L1, which could hold stale lines.  An entry
//     rewritten during a chase holds the pointer or the value; a reader
//     may see either, and either is true.
//   - Flags and tickets are zeroed by a memset on the stream before every
//     launch: two device operations a call.
//   - Long distances.  A source many tiles back is one more step of a
//     chase, into a tile that has published.
//   - out_cap or total not a multiple of the tile: the last tile is
//     narrower, bytes past the total are written zero, and a row that is
//     not a multiple of 16 bytes is written a byte at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kTile = 8192;  // output bytes a block expands
constexpr int kThreads = 512;
constexpr int kPer = kTile / kThreads;  // bytes a thread, contiguous
constexpr int kWarps = kThreads / 32;
constexpr int kLit = 0, kMatch = 1;
// a wait longer than about a second (a poll is at least a trip through L2)
// can only be a fault: the kernel traps instead of hanging the card
constexpr int kMaxPolls = 1 << 22;
static_assert(kPer % 16 == 0 && kPer <= 32,
              "a thread moves whole 16-byte words; chases fit a mask");

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The owners of positions pa and pb: the last of tokens [0, n) whose
// offset is at or before the position, -1 where none is.  Called by every
// thread of the block, each probe a round read by one thread.
__device__ int2 owners(const int* __restrict__ off, int n, int pa, int pb) {
  int lo[2] = {0, 0}, cnt[2] = {n, n};
  int res[2] = {n > 0 ? -2 : -1, n > 0 ? -2 : -1};  // -2: not found yet
  const int p[2] = {pa, pb};
  while (res[0] == -2 || res[1] == -2) {  // uniform across the block
    int step[2], c[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      step[s] = (cnt[s] + kThreads - 1) / kThreads;
      const int at = threadIdx.x * step[s];
      c[s] = __syncthreads_count(res[s] == -2 && at < cnt[s] &&
                                 __ldg(off + lo[s] + at) <= p[s]);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (res[s] != -2) continue;
      if (c[s] == 0) {  // the first candidate is past p: the one before
        res[s] = lo[s] - 1;
        continue;
      }
      lo[s] += (c[s] - 1) * step[s];
      cnt[s] = min(step[s], cnt[s] - (c[s] - 1) * step[s]);
      if (cnt[s] == 1) res[s] = lo[s];
    }
  }
  return make_int2(res[0], res[1]);
}

__global__ void __launch_bounds__(kThreads) expand2_kernel(
    const int* __restrict__ off, const int* __restrict__ c1,
    const int* __restrict__ tb, const int* __restrict__ tp,
    const int* __restrict__ total, uint8_t* __restrict__ out, int* sync,
    int* pub, int B, int K, int out_cap, int ntiles) {
  extern __shared__ int4 smem4[];
  int* ref = (int*)smem4;                  // [kTile] owner, then parent
  uint8_t* val = (uint8_t*)(ref + kTile);  // [kTile] a root's value
  uint8_t* fin = val + kTile;              // [kTile] the tile's bytes
  __shared__ int s_ticket, s_hi;
  __shared__ int warp_max[kWarps];
  const int tid = threadIdx.x, wid = tid >> 5, lid = tid & 31;

  if (tid == 0) {
    s_ticket = atomicAdd(sync, 1);
    s_hi = -1;
  }
  __syncthreads();
  const int lane = s_ticket % B, tile = s_ticket / B;
  int* flags = sync + 1 + (size_t)lane * ntiles;
  const int t0 = tile * kTile;
  const int width = min(kTile, out_cap - t0);
  const int ntok = min(max(tp[lane], 0), K);
  const int live = max(0, min(width, min(max(total[lane], 0), out_cap) - t0));
  const int* offl = off + (size_t)lane * K;
  const int* c1l = c1 + (size_t)lane * K;
  const int* tbl = tb + (size_t)lane * K;
  uint8_t* outl = out + (size_t)lane * out_cap;

  // 2. owners: the first live byte's owner at byte 0, each token that
  // starts inside the tile at its start, then a max-scan.  A thread keeps
  // its kPer contiguous bytes in registers and moves them to and from
  // shared memory 16 bytes at a time.
  const int2 own = live > 0 ? owners(offl, ntok, t0, t0 + live - 1)
                            : make_int2(-1, -1);
  const int k0 = tid * kPer;
  int4* ref4 = (int4*)(ref + k0);
#pragma unroll
  for (int h = 0; h < kPer / 4; ++h) {
    ref4[h] = make_int4(k0 + 4 * h == 0 ? own.x : -1, -1, -1, -1);
  }
  __syncthreads();
  for (int i = own.x + 1 + tid; i <= own.y; i += kThreads) {
    const int k = offl[i] - t0;  // in (0, live) where offsets do not decrease
    if (k > 0 && k < live) atomicMax(&ref[k], i);  // equal: zero-length tokens
  }
  __syncthreads();
  int o4[kPer];
#pragma unroll
  for (int h = 0; h < kPer / 4; ++h) {
    const int4 x = ref4[h];
    o4[4 * h] = x.x, o4[4 * h + 1] = x.y, o4[4 * h + 2] = x.z, o4[4 * h + 3] = x.w;
  }
  int m = -1;
#pragma unroll
  for (int j = 0; j < kPer; ++j) m = max(m, o4[j]);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, m, d);
    if (lid >= d) m = max(m, up);
  }
  if (lid == 31) warp_max[wid] = m;
  __syncthreads();
  if (wid == 0) {
    int w = lid < kWarps ? warp_max[lid] : -1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lid >= d) w = max(w, up);
    }
    if (lid < kWarps) warp_max[lid] = w;
  }
  __syncthreads();
  // the owner carried into this thread's bytes
  m = __shfl_up_sync(0xffffffffu, m, 1);
  if (lid == 0) m = -1;
  if (wid > 0) m = max(m, warp_max[wid - 1]);

  // 3. parents: each thread its own bytes, written over their owners
  uint32_t v4[kPer / 4] = {};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = k0 + j, p = t0 + k;
    m = max(m, o4[j]);
    int r = k;
    if (k < live && m >= 0) {
      const int c = __ldg(c1l + m);
      const int kind = (c >> 9) & 3;
      if (kind == kLit) {
        v4[j >> 2] |= (uint32_t)(c & 0xFF) << (8 * (j & 3));
      } else if (kind == kMatch) {
        const int d = __ldg(tbl + m);
        const int o = __ldg(offl + m);
        if (d > 0 && o <= p) {
          const int s = max(o - d + (p - o) % d, 0);
          r = s >= t0 ? s - t0 : -(s + 1);
        }
      }
    }
    o4[j] = r;
  }
#pragma unroll
  for (int h = 0; h < kPer / 4; ++h) {
    ref4[h] = make_int4(o4[4 * h], o4[4 * h + 1], o4[4 * h + 2], o4[4 * h + 3]);
  }
#pragma unroll
  for (int h = 0; h < kPer / 16; ++h) {
    ((uint4*)(val + k0))[h] =
        make_uint4(v4[4 * h], v4[4 * h + 1], v4[4 * h + 2], v4[4 * h + 3]);
  }
  __syncthreads();

  // 4. in-tile chains, jumped until nothing moves
  while (true) {
    bool moved = false;
    for (int k = tid; k < live; k += kThreads) {
      const int r = ref[k];
      if (r >= 0) {
        const int r2 = ref[r];
        if (r2 != r) {
          ref[k] = r2;
          moved = true;
        }
      }
    }
    if (!__syncthreads_or(moved)) break;
  }

  // 5. publish: each live byte's entry in the lane's chain table, its
  // value where its chain ends inside the tile (as -1 - value), else the
  // row position of the first byte before the tile on its chain; then
  // the tile's flag
  int* publ = pub + (size_t)lane * out_cap;
  int hi = -1;
  for (int k = tid; k < live; k += kThreads) {
    const int r = ref[k];
    publ[t0 + k] = r >= 0 ? -1 - (int)val[r] : -r - 1;
    if (r < 0) hi = max(hi, (-r - 1) / kTile);
  }
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lid == 0 && hi >= 0) atomicMax(&s_hi, hi);
  __syncthreads();  // orders every thread's entries before the release
  if (tid == 0) st_release(flags + tile, 1);

  // 6. wait until the lane's tiles up to the highest one named have
  // published (each publishes without waiting on any other)
  if (tid <= s_hi) {
    const int* f = flags + tid;
    for (int polls = 0; ld_acquire(f) == 0; ++polls) {
      if (polls == kMaxPolls) __trap();  // an error, never a hung card
      __nanosleep(32);
    }
  }
  __syncthreads();

  // 7. the tile's bytes, a thread every kThreads-th byte: a value of the
  // tile, or the end of the chain of published entries (ld.global.cg),
  // each step at least one tile back; a thread's kPer chases step
  // together, so their reads are in flight at once.  A chain that ends in
  // a value is written back over the byte's entry, so that later chases
  // through it stop there: a reader sees the pointer or the value, and
  // both are true.
  int e[kPer];
  uint32_t chased = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = ref[tid + j * kThreads];  // a root of value 0 past live
    e[j] = r >= 0 ? -1 - (int)val[r] : -r - 1;
    if (r < 0) chased |= 1u << j;
  }
  for (bool more = chased != 0; more;) {
    more = false;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (e[j] >= 0) {
        e[j] = __ldcg(publ + e[j]);
        more = true;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = tid + j * kThreads;
    if (chased >> j & 1) publ[t0 + k] = e[j];
    if (k < width) fin[k] = (uint8_t)(-1 - e[j]);
  }
  __syncthreads();
  uint8_t* dst = outl + t0;
  const bool wide = ((uintptr_t)dst & 15) == 0;
  for (int k = 16 * tid; k < width; k += 16 * kThreads) {
    if (wide && k + 16 <= width) {
      *(uint4*)(dst + k) = *(const uint4*)(fin + k);
    } else {
      for (int b = k; b < min(k + 16, width); ++b) dst[b] = fin[b];
    }
  }
}

}  // namespace

// sync: int32[sync_words] scratch, at least 1 + B * ceil(out_cap / kTile)
// words (a ticket counter, then one flag a tile), zeroed here; pub:
// int32[B * out_cap] scratch, the lanes' chain tables.
extern "C" int expand2_launch(const void* off, const void* c1, const void* tb,
                              const void* tp, const void* total, void* out,
                              void* sync, int sync_words, void* pub, int B,
                              int K, int out_cap, void* stream) {
  static launch::DynSmem limit;
  const int smem = kTile * (int)(sizeof(int) + 2);
  cudaError_t e = limit.fit(expand2_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (out_cap + kTile - 1) / kTile;
  const long long words = 1 + (long long)B * ntiles;
  if (B < 1 || out_cap < 1 || words > sync_words) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(sync, 0, words * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  expand2_kernel<<<(unsigned)(words - 1), kThreads, smem, s>>>(
      (const int*)off, (const int*)c1, (const int*)tb, (const int*)tp,
      (const int*)total, (uint8_t*)out, (int*)sync, (int*)pub, B, K, out_cap,
      ntiles);
  return (int)cudaGetLastError();
}
