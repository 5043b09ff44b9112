// The dynamic Huffman trees of the dynamic-trees encode, a block a lane:
// the literal/length count of every token start and the distance count
// of every start whose symbol is a length code (257..285: the start is a
// match), the end-of-block's 1, distance code 0 forced where the lane has
// no match; each tree's length-limited code lengths by the JAX package's
// rule (lengths ceil(log2(total / f)) clipped to [1, max_bits]; 48 rounds
// that lengthen the rarest shortenable symbol while the code is
// oversubscribed; two sweeps over the levels max_bits .. 2 that shorten a
// level's most frequent symbols, ties by index, while the budget allows;
// a lone symbol at length 1); canonical codes, bit-reversed; the RFC 1951
// 3.2.7 run-length ops of the 316 lengths and the code-length tree
// (19 symbols, at most 7 bits); the header; the Kraft checks; and the
// choice of dynamic trees where header and tokens take fewer bits than
// the static trees.  The output of ops/encode.py's _dynamic_trees_plain
// (the plain version), element for element.
//
// Replaces no Pallas kernel: the JAX package builds its trees with jnp
// glue (tpu_deflate/ops/encode.py: _assign_code_lengths_jax,
// _canonical_codes_jax, _rle_code_lengths_jax and the choice in
// _encode_emissions), which XLA fuses on the TPU.  Its port in torch is
// about 1900 dispatched ops a call on rows of 286 and 19 symbols (the
// deficit sweeps alone take two stable argsorts a level): the card waits
// on the host's dispatch, an emit stage of 43-70 ms for 128 lanes of 64 KiB
// on an H100.
//
// Bound on the card: memory traffic.  The job reads a start flag a
// position and a token's symbols, and writes 10561 bytes of tables and
// header a lane; the rule is a few thousand integer steps on at most 316
// symbols.  One block of 512 threads a lane (a thread a symbol, a header
// slot, a table entry) keeps every step in shared memory:
//   1. the counts: 16 start flags a load, the symbols of their starts
//      loaded together, then their matches' distances, one shared atomic
//      each;
//   2. each tree: the ceil rule and a histogram of the lengths, from
//      which every thread keeps the Kraft sum; the repair's pick by one
//      block minimum of (count, index, length), raised in place as the
//      rounds run; at each level of the sweeps the promotions counted
//      from the histogram (none at most levels, which then cost nothing),
//      each symbol of the level ranked by a pass over the counts;
//   3. canonical codes from the histogram and each symbol's rank by
//      index within its length;
//   4. one thread's walk of the runs of the 316 lengths (at most 316
//      ops), counting the code-length symbols;
//   5. one block sum of each header width and each symbol's count times
//      its change of length against the static trees decides the choice
//      (a token's extra bits are alike under either tree and cancel).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLit = 286;            // literal/length symbols counted
constexpr int kDist = 30;            // distance symbols counted
constexpr int kCl = 19;              // code-length symbols
constexpr int kLens = kLit + kDist;  // lengths run-length encoded
constexpr int kOps = 320;            // header op slots
constexpr int kHdr = 1 + kCl + kOps; // header entries
constexpr int kLitOut = 288, kDistOut = 32;  // table widths
constexpr int kRounds = 48;          // the overflow repair's rounds
static_assert(kHdr <= kThreads && kLitOut <= kThreads,
              "a thread a symbol, a table entry and a header entry");

__constant__ int kClOrder[kCl] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                  11, 4, 12, 3, 13, 2, 14, 1, 15};

struct Shared {
  int lf[kLit];   // literal/length counts, the end-of-block's 1 in
  int df[kDist];  // distance counts of the lane's matches
  int dff[kDist]; // the same, code 0 forced where there is no match
  int len[kLens]; // code lengths: literal/length, then distance
  int code[kLens];  // their canonical codes, bit-reversed
  int clf[kCl], cllen[kCl], clcode[kCl];  // the code-length tree
  uint8_t op_sym[kOps], op_extra[kOps];   // the header's run-length ops
  int nops;
  int cnt[16];    // histogram of the lengths of the tree at work
  long long red[kWarps];
  unsigned long long ured[kWarps];
};

struct Tree {
  int kraft;    // Kraft sum in units of 2^-max_bits
  int nactive;  // symbols with a count
};

__device__ long long block_sum(long long v, long long* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // the last reduction's reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long r = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r += red[w];
  return r;
}

__device__ unsigned long long block_min(unsigned long long v,
                                        unsigned long long* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = min(r, red[w]);
  return r;
}

// The lengths (into len) of the S counts f, both in shared memory, at
// most max_bits bits; every thread of the block calls it, thread i owns
// symbol i.
__device__ __noinline__ Tree build_lengths(const int* f, int* len, int S,
                                           int max_bits, Shared& s) {
  const int tid = threadIdx.x;
  const int unit = 1 << max_bits;
  const int fi = tid < S ? f[tid] : 0;
  if (tid < 16) s.cnt[tid] = 0;
  const long long total = block_sum(fi, s.red);
  const int nactive = (int)block_sum(fi > 0, s.red);
  int li = 0;
  if (fi > 0) {
    // ceil(log2(total / f)) from q = floor(total / f): one more bit where
    // q is a power of two and the division has a remainder
    const unsigned long long q = (unsigned long long)total / fi;
    const int blen = 64 - __clzll((long long)q);
    const bool pow2 = (q & (q - 1)) == 0;
    li = min(max((pow2 ? blen - 1 : blen) + (pow2 && total % fi != 0), 1),
             max_bits);
    atomicAdd(&s.cnt[li], 1);
  }
  if (tid < S) len[tid] = li;
  __syncthreads();
  int kraft = 0;
  for (int l = 1; l <= max_bits; ++l) kraft += s.cnt[l] << (max_bits - l);

  // the repair: a round lengthens the rarest symbol of length 1 ..
  // max_bits - 1 (the first by index) while the code is oversubscribed;
  // the pick stays the same until it reaches max_bits
  int rounds = kRounds;
  while (kraft > unit && rounds > 0) {
    const bool can = li > 0 && li < max_bits;
    const unsigned long long key = block_min(
        can ? (unsigned long long)fi << 13 | tid << 4 | li : ~0ull, s.ured);
    if (key == ~0ull) break;  // none: an oversubscribed code always has one
    const int pick = (int)(key >> 4) & 511;
    const int l0 = (int)(key & 15);
    int l = l0;
    for (; l < max_bits && kraft > unit && rounds > 0; ++l, --rounds)
      kraft -= 1 << (max_bits - l - 1);
    if (tid == pick) {
      li = l;
      len[tid] = l;
      s.cnt[l0] -= 1;
      s.cnt[l] += 1;
    }
  }
  __syncthreads();

  // the sweeps: at each level the k most frequent symbols (ties by index)
  // move up a level, k what the budget allows at the level's granularity
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int lvl = max_bits; lvl >= 2; --lvl) {
      const int shift = max_bits - lvl;
      const int deficit = unit - kraft;
      const int k = deficit >= 0 ? deficit >> shift : -1;
      const int p = min(k, s.cnt[lvl]);
      if (p <= 0) continue;  // alike in every thread
      bool promote = false;
      if (li == lvl) {
        int rank = 0;
        for (int j = 0; j < S; ++j) {
          const int fj = f[j];
          rank += len[j] == lvl && (fj > fi || (fj == fi && j < tid));
        }
        promote = rank < k;
      }
      __syncthreads();  // every rank and count read the level as it was
      if (promote) {
        li = lvl - 1;
        len[tid] = li;
      }
      if (tid == 0) {
        s.cnt[lvl] -= p;
        s.cnt[lvl - 1] += p;
      }
      kraft += p << shift;
      __syncthreads();
    }
  }
  if (nactive == 1) {  // a lone symbol
    if (fi > 0) len[tid] = 1;
    kraft = 1 << (max_bits - 1);
  }
  __syncthreads();
  return {kraft, nactive};
}

// RFC 1951 canonical codes of the S lengths len, bit-reversed, into code.
__device__ __noinline__ void canonical_codes(const int* len, int* code, int S,
                                             Shared& s) {
  const int tid = threadIdx.x;
  if (tid < 16) s.cnt[tid] = 0;
  __syncthreads();
  const int li = tid < S ? len[tid] : 0;
  if (li > 0) atomicAdd(&s.cnt[li], 1);
  __syncthreads();
  if (tid < S) {
    int c = 0;
    if (li > 0) {
      int next = 0;  // the first code of length li
      for (int l = 1; l < li; ++l) next = (next + s.cnt[l]) << 1;
      int rank = 0;
      for (int j = 0; j < tid; ++j) rank += len[j] == li;
      // the low 16 bits reversed, then down to li bits
      c = (int)((__brev((unsigned)(next + rank) & 0xFFFFu) >> 16) >> (16 - li));
    }
    code[tid] = c;
  }
  __syncthreads();
}

// One thread: the run-length ops of the 316 lengths (symbols 0-15; 16,
// the previous length 3-6 times; 17, 3-10 zeros; 18, 11-138 zeros), and
// the count of each symbol.
__device__ __noinline__ void run_length_ops(Shared& s) {
  int o = 0;
  auto put = [&](int sym, int extra) {
    s.op_sym[o] = (uint8_t)sym;
    s.op_extra[o] = (uint8_t)extra;
    s.clf[sym] += 1;
    ++o;
  };
  for (int i = 0; i < kLens;) {
    const int v = s.len[i];
    int j = i + 1;
    while (j < kLens && s.len[j] == v) ++j;
    int run = j - i;
    if (v == 0) {
      for (; run >= 138; run -= 138) put(18, 138 - 11);
      if (run >= 11) {
        put(18, run - 11);
      } else if (run >= 3) {
        put(17, run - 3);
      } else {
        for (; run > 0; --run) put(0, 0);
      }
    } else {
      put(v, 0);
      int rest = run - 1;
      for (; rest >= 6; rest -= 6) put(16, 3);
      if (rest >= 3) {
        put(16, rest - 3);
      } else {
        for (; rest > 0; --rest) put(v, 0);
      }
    }
    i = j;
  }
  s.nops = o;
}

// RFC 1951 3.2.6's fixed literal/length code of symbol i: its length, and
// its code bit-reversed.
__device__ __forceinline__ int static_len(int i) {
  return i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
}

__device__ __forceinline__ int static_code(int i) {
  const unsigned c = i < 144   ? 0x30 + i
                     : i < 256 ? 0x190 + (i - 144)
                     : i < 280 ? i - 256
                               : 0xC0 + (i - 280);
  return (int)(__brev(c) >> (32 - static_len(i)));
}

__global__ void __launch_bounds__(kThreads)
dyntrees_kernel(const uint8_t* __restrict__ start,
                const int64_t* __restrict__ lsym,
                const int64_t* __restrict__ dsym, int N,
                uint8_t* __restrict__ use_dyn, int64_t* __restrict__ lit_code,
                int64_t* __restrict__ lit_len, int64_t* __restrict__ dist_code,
                int64_t* __restrict__ dist_len, int64_t* __restrict__ hdr_vals,
                int64_t* __restrict__ hdr_nbs) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  if (tid < kLit) s.lf[tid] = tid == 256;  // the end-of-block
  if (tid < kDist) s.df[tid] = 0;
  if (tid < kCl) s.clf[tid] = 0;
  __syncthreads();

  // 1. the counts: 16 start flags a load (byte loads where the row is not
  // aligned to 16); the symbols of the 16 positions' starts loaded all at
  // once, then the distances of their matches, so a group waits on memory
  // twice and not once a token
  const size_t row = (size_t)b * N;
  const uint8_t* st = start + row;
  const int64_t* ls = lsym + row;
  const int64_t* ds = dsym + row;
  const int nvec = ((uintptr_t)st & 15) == 0 ? N / 16 : 0;
  for (int j = tid; j < nvec; j += kThreads) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(st) + j);
    if ((w.x | w.y | w.z | w.w) == 0) continue;
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    const int i0 = 16 * j;
    int sym[16], dist[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      sym[k] = (words[k >> 2] >> (8 * (k & 3))) & 0xFFu ? (int)__ldg(ls + i0 + k) : -1;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      dist[k] = sym[k] >= 257 ? (int)__ldg(ds + i0 + k) : -1;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (sym[k] >= 0) atomicAdd(&s.lf[sym[k]], 1);
      if (dist[k] >= 0) atomicAdd(&s.df[dist[k]], 1);
    }
  }
  for (int i = 16 * nvec + tid; i < N; i += kThreads) {
    if (st[i]) {
      const int sym = (int)ls[i];
      atomicAdd(&s.lf[sym], 1);
      if (sym >= 257) atomicAdd(&s.df[(int)ds[i]], 1);
    }
  }
  __syncthreads();
  // RFC 1951 wants at least one distance code even when none is used
  const long long matches = block_sum(tid < kDist ? s.df[tid] : 0, s.red);
  if (tid < kDist) s.dff[tid] = s.df[tid] + (tid == 0 && matches == 0);
  __syncthreads();

  // 2, 3. both trees and their codes
  const Tree lit = build_lengths(s.lf, s.len, kLit, 15, s);
  const Tree dist = build_lengths(s.dff, s.len + kLit, kDist, 15, s);
  canonical_codes(s.len, s.code, kLit, s);
  canonical_codes(s.len + kLit, s.code + kLit, kDist, s);

  // 4. the header: HLIT = 286, HDIST = 30, HCLEN = 19, the 19 code-length
  // code lengths, then the run-length ops of the 316 lengths
  if (tid == 0) run_length_ops(s);
  __syncthreads();
  const Tree cl = build_lengths(s.clf, s.cllen, kCl, 7, s);
  canonical_codes(s.cllen, s.clcode, kCl, s);
  int val = 0, nb = 0;  // header entry tid
  if (tid == 0) {
    val = (286 - 257) | ((30 - 1) << 5) | ((19 - 4) << 10);
    nb = 14;
  } else if (tid <= kCl) {
    val = s.cllen[kClOrder[tid - 1]];
    nb = 3;
  } else if (tid < kHdr && tid - 1 - kCl < s.nops) {
    const int o = tid - 1 - kCl;
    const int sym = s.op_sym[o];
    const int l = s.cllen[sym];
    val = s.clcode[sym] | s.op_extra[o] << l;
    nb = l + (sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0);
  }

  // 5. dynamic bits less static ones: the header's, then each symbol's
  // count times its change of length (the end-of-block's in the counts)
  long long part = nb;
  if (tid < kLit) part += (long long)s.lf[tid] * (s.len[tid] - static_len(tid));
  if (tid < kDist) part += (long long)s.df[tid] * (s.len[kLit + tid] - 5);
  const long long diff = block_sum(part, s.red);
  // zlib rejects incomplete literal and code-length trees; a one-code
  // distance tree is tolerated
  const bool allow = cl.nactive >= 2 && lit.nactive >= 2 &&
                     lit.kraft == 1 << 15 && cl.kraft == 1 << 7 &&
                     (dist.kraft == 1 << 15 || dist.nactive <= 1);
  const bool use = allow && diff < 0;

  // the tables, the static ones where the lane keeps static trees
  if (tid < kLitOut) {
    const size_t at = (size_t)b * kLitOut + tid;
    lit_code[at] = use ? (tid < kLit ? s.code[tid] : 0) : static_code(tid);
    lit_len[at] = use ? (tid < kLit ? s.len[tid] : 0) : static_len(tid);
  }
  if (tid < kDistOut) {
    const size_t at = (size_t)b * kDistOut + tid;
    dist_code[at] = use ? (tid < kDist ? s.code[kLit + tid] : 0)
                        : (int)(__brev((unsigned)tid) >> 27);
    dist_len[at] = use ? (tid < kDist ? s.len[kLit + tid] : 0) : 5;
  }
  if (tid < kHdr) {
    const size_t at = (size_t)b * kHdr + tid;
    hdr_vals[at] = val;
    hdr_nbs[at] = use ? nb : 0;
  }
  if (tid == 0) use_dyn[b] = use;
}

}  // namespace

extern "C" int dyntrees_launch(const void* start, const void* lsym,
                               const void* dsym, void* use_dyn, void* lit_code,
                               void* lit_len, void* dist_code, void* dist_len,
                               void* hdr_vals, void* hdr_nbs, int B, int N,
                               void* stream) {
  dyntrees_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)start, (const int64_t*)lsym, (const int64_t*)dsym, N,
      (uint8_t*)use_dyn, (int64_t*)lit_code, (int64_t*)lit_len,
      (int64_t*)dist_code, (int64_t*)dist_len, (int64_t*)hdr_vals,
      (int64_t*)hdr_nbs);
  return (int)cudaGetLastError();
}
