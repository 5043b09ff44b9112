// Decode stage 1 of one static- or dynamic-tree block in one lane, tile
// parallel: a candidate symbol at every bit position, per-tile transfer
// maps, and a walk of every 64-bit tile at once.
//
// Replaces: tpu_deflate/kernels/tokenize_dyn.py, tokenize_dyn_batch with
// hier=True, tier=2 (Pallas bodies _k1d_kernel and _k3d_kernel; between
// them chase1.ent_from_phi, csrc/chase1.cu).  The TPU form builds the same
// maps with five rounds of packed-select pointer doubling and compacts the
// tokens with one-hot MXU products.
//
// Bound on the card: bytes and launches.  k1d reads the window (64 KiB at
// pw = 2^19) and writes a 4-byte field and a map byte per bit position,
// 2.5 MiB; k3d reads the fields of the true symbols only (the next
// symbol's phase follows from them) and writes the tokens.  What is
// serial is short: a chain of at most 32 links inside a tile (every
// literal/length code of the block is at least 2 bits, so a symbol that
// does not end the block is at least 2 bits wide), 33 visits a tile, and
// one block-wide scan.
//
// k1d, one thread per bit position, 16 tiles a block: the block's window
// bytes and the lane's tables go to shared memory; each thread decodes the
// symbol starting at its position (dyn_sym.cuh; a position at or past the
// end bit is K_BAD of width 1), stores its fields kind | adv | ta |
// dist - 1, and puts its one-step map in shared memory: 255 at a
// terminator (end-of-block or bad code), else its phase + adv.  Then
// thread (tile, e) follows the tile's one-step maps from phase e for up to
// 32 links: the entry phase in the next tile, or STOP.  Bytes at or past
// pw / 8 read as zero, as in the TPU form, whose last tile sees no next
// tile.
//
// k3d, one block of 1024 threads, T / 1024 tiles each: every tile walks
// from its entry phase (ent_from_phi) for at most WLK = 33 visits, reading
// each visited symbol's fields; a tile whose 32768-bit chunk starts at or
// past the end bit is not walked, as in the TPU form.  A first walk counts
// tokens and output bytes per tile, one scan gives each tile its first
// slot and output offset, and a second walk writes the tokens and checks
// each distance against the output before it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dyn_sym.cuh"

namespace {

using namespace dyn;

constexpr int TILE = 64;
constexpr int STOP = 191;
constexpr int THREADS = 1024;
constexpr int K1_TILES = THREADS / TILE;  // tiles per k1d block
constexpr int MAXPER = 8;                 // tiles per k3d thread
constexpr int WLK = 33;                   // visits per tile

__global__ void __launch_bounds__(THREADS)
    k1d_kernel(const uint8_t* __restrict__ row, int nbytes,
               const int* __restrict__ end_bits, const int* __restrict__ tab,
               int* __restrict__ plane, uint8_t* __restrict__ phi, int T) {
  __shared__ Tables tabs;
  __shared__ uint8_t win[K1_TILES * 8 + 8];
  __shared__ uint8_t m0s[THREADS];
  load_tables(tabs, tab);
  const int byte0 = blockIdx.x * K1_TILES * 8;
  for (int k = threadIdx.x; k < K1_TILES * 8 + 8; k += blockDim.x) {
    win[k] = byte0 + k < nbytes ? __ldg(row + byte0 + k) : 0;
  }
  __syncthreads();

  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int q = p % TILE;
  Sym s{K_BAD, 1, 0, 0};
  if (p < *end_bits) {
    uint64_t w = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      w |= (uint64_t)win[(threadIdx.x >> 3) + k] << (8 * k);
    }
    s = dyn_symbol(w >> (p & 7), tabs.lim[0], tabs.rd[0], tabs.lit_sym,
                   tabs.lim[1], tabs.rd[1], tabs.dist_sym);
  }
  plane[p] = (int)(((unsigned)s.kind << 30) | ((unsigned)s.adv << 24) |
                   ((unsigned)s.ta << 15) |
                   (s.kind == K_MATCH ? (unsigned)(s.dist - 1) : 0u));
  m0s[threadIdx.x] =
      (uint8_t)(s.kind == K_EOB || s.kind == K_BAD ? 255 : q + s.adv);
  __syncthreads();

  // thread (tile, e): the tile's transfer map at entry phase e
  const int lt = threadIdx.x / TILE, e = threadIdx.x % TILE;
  const int t = blockIdx.x * K1_TILES + lt;
  int x = e;
  for (int k = 0; k < 32 && x < TILE; ++k) x = m0s[lt * TILE + x];
  const int out = x >= 2 * TILE ? STOP : ((x - TILE) & 0xFF);
  phi[(((size_t)(e >> 2) * T + t) << 2) + (e & 3)] = (uint8_t)out;
}

// The fields of the symbol at bit p: (kind, adv, ta, dist).
struct Field {
  int kind, adv, ta, dist;
};

__device__ __forceinline__ Field field_at(const int* plane, int p, int end) {
  const unsigned v = (unsigned)__ldg(plane + p);
  Field f{(int)(v >> 30), (int)((v >> 24) & 0x3F), (int)((v >> 15) & 0x1FF),
          (int)(v & 0x7FFF) + 1};
  if (p >= end) f.kind = K_BAD;
  return f;
}

// Exclusive block-wide prefix sum of v; *total gets the sum.
__device__ unsigned long long block_exscan(unsigned long long v,
                                           unsigned long long* warp_sums,
                                           unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long o = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    unsigned long long w = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long o = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += o;
    }
    if (lane < nw) warp_sums[lane] = w;
    if (lane == nw - 1) *total = w;
  }
  __syncthreads();
  return inc - v + (warp ? warp_sums[warp - 1] : 0);
}

__global__ void __launch_bounds__(THREADS)
    k3d_kernel(const int* __restrict__ plane, const int* __restrict__ ent,
               const int* __restrict__ end_bits, const int* __restrict__ tab,
               int* __restrict__ tk, int* __restrict__ ta,
               int* __restrict__ tb, int* __restrict__ meta, int T,
               int chunk, int tokcap) {
  __shared__ unsigned long long warp_sums[32];
  __shared__ unsigned long long total;
  __shared__ int eob_pk;
  const int end = *end_bits;
  const int out_base = tab[TAB_OUTBASE];
  const int per = T / blockDim.x;
  if (threadIdx.x == 0) eob_pk = -1;

  int cur[MAXPER];
  unsigned ntok[MAXPER], nbytes[MAXPER];
  bool bad = false;
  int eob = -1;
  // first walk: tokens and output bytes of each tile
#pragma unroll
  for (int j = 0; j < MAXPER; ++j) {
    const int t = threadIdx.x * per + j;
    cur[j] = j < per && TILE * (t - t % chunk) < end ? ent[t] : -1;
    ntok[j] = nbytes[j] = 0;
  }
  for (int v = 0; v < WLK; ++v) {
#pragma unroll
    for (int j = 0; j < MAXPER; ++j) {
      const int x = cur[j];
      if ((unsigned)x >= (unsigned)TILE) continue;
      const int p = TILE * (threadIdx.x * per + j) + x;
      const Field f = field_at(plane, p, end);
      if (f.kind == K_LIT || f.kind == K_MATCH) {
        ++ntok[j];
        nbytes[j] += f.kind == K_LIT ? 1 : f.ta;
      }
      bad |= f.kind == K_BAD;
      if (f.kind == K_EOB) eob = max(eob, (p << 6) | f.adv);
      cur[j] = f.kind == K_EOB || f.kind == K_BAD ? 255 : x + f.adv;
    }
  }
  unsigned long long mine = 0;
#pragma unroll
  for (int j = 0; j < MAXPER; ++j) {
    if (j < per) mine += ntok[j] | ((unsigned long long)nbytes[j] << 32);
  }
  const unsigned long long base = block_exscan(mine, warp_sums, &total);
  if (eob >= 0) atomicMax(&eob_pk, eob);

  // second walk: write the tokens at their slots, check the distances
  bool too_far = false;
  unsigned slot_at[MAXPER], run_at[MAXPER];
  {
    unsigned long long acc = base;
#pragma unroll
    for (int j = 0; j < MAXPER; ++j) {
      const int t = threadIdx.x * per + j;
      cur[j] = j < per && TILE * (t - t % chunk) < end ? ent[t] : -1;
      slot_at[j] = (unsigned)(acc & 0xFFFFFFFFu);
      run_at[j] = (unsigned)(acc >> 32) + out_base;
      if (j < per) acc += ntok[j] | ((unsigned long long)nbytes[j] << 32);
    }
  }
  for (int v = 0; v < WLK; ++v) {
#pragma unroll
    for (int j = 0; j < MAXPER; ++j) {
      const int x = cur[j];
      if ((unsigned)x >= (unsigned)TILE) continue;
      const int p = TILE * (threadIdx.x * per + j) + x;
      const Field f = field_at(plane, p, end);
      if (f.kind == K_LIT || f.kind == K_MATCH) {
        const bool m = f.kind == K_MATCH;
        too_far |= m && (unsigned)f.dist > run_at[j];
        if (slot_at[j] < (unsigned)tokcap) {
          tk[slot_at[j]] = m ? TK_MATCH : TK_LIT;
          ta[slot_at[j]] = f.ta;
          tb[slot_at[j]] = m ? f.dist : 0;
        }
        ++slot_at[j];
        run_at[j] += m ? f.ta : 1;
      }
      cur[j] = f.kind == K_EOB || f.kind == K_BAD ? 255 : x + f.adv;
    }
  }
  const bool any_bad = __syncthreads_or(bad);
  const bool any_far = __syncthreads_or(too_far);
  if (threadIdx.x == 0) {
    const int n = (int)(total & 0xFFFFFFFFu);
    const bool cap_ok = n < tokcap - 8;
    int err;
    if (any_far) {
      err = ERR_DIST;
    } else if (!cap_ok) {
      err = ERR_OVERFLOW;
    } else if (any_bad) {
      err = ERR_BAD_CODE;
    } else {
      err = eob_pk >= 0 ? ERR_OK : ERR_INPUT;
    }
    int end_pos = eob_pk >= 0 ? (eob_pk >> 6) + (eob_pk & 63) : end;
    if (end <= 3) {  // an empty lane
      err = ERR_OK;
      end_pos = 0;
    }
    meta[0] = n;
    meta[1] = (int)(total >> 32);
    meta[2] = end_pos;
    meta[3] = err;
  }
}

}  // namespace

// row: uint8[M] of one lane, nbytes = min(M, pw / 8); plane: int32[pw];
// phi: int32[16, pw / 64].
extern "C" int tokenize_hier_k1d_launch(const void* row, int nbytes,
                                        const void* end_bits, const void* tab,
                                        void* plane, void* phi, int pw,
                                        void* stream) {
  k1d_kernel<<<pw / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)row, nbytes, (const int*)end_bits, (const int*)tab,
      (int*)plane, (uint8_t*)phi, pw / TILE);
  return (int)cudaGetLastError();
}

// ent: int32[T]; tk, ta, tb: int32[tokcap], zero; meta: int32[4] = ntok,
// out_total, end_pos, err.  T a power of two, 128 <= T <= 8192.
extern "C" int tokenize_hier_k3d_launch(const void* plane, const void* ent,
                                        const void* end_bits, const void* tab,
                                        void* tk, void* ta, void* tb,
                                        void* meta, int T, int chunk,
                                        int tokcap, void* stream) {
  k3d_kernel<<<1, T < THREADS ? T : THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)plane, (const int*)ent, (const int*)end_bits,
      (const int*)tab, (int*)tk, (int*)ta, (int*)tb, (int*)meta, T, chunk,
      tokcap);
  return (int)cudaGetLastError();
}
