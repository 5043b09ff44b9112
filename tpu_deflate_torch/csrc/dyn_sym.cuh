// One candidate symbol under a block's canonical Huffman tables, shared by
// the dynamic tokenizer (tokenize_dyn.cu, for codes longer than its
// first-level tables take) and the tile-parallel one (tokenize_hier.cu).
//
// The tables come packed, TAB_W int32 per lane (layout TAB_* in
// kernels/tokenize_dyn.py).  A code's length is the number of limits
// lim[1..15] that its 15-bit MSB-first prefix does not undercut, plus one,
// its rank the prefix's top bits plus rd[length]; the rank names the
// symbol through the rank -> symbol tables, which load_tables() unpacks
// into shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "pass.cuh"

namespace dyn {

// the error codes, token and symbol kinds, and the symbol of pass.cuh
using pass::ERR_BAD_CODE;
using pass::ERR_DIST;
using pass::ERR_INPUT;
using pass::ERR_OK;
using pass::ERR_OVERFLOW;
using pass::K_BAD;
using pass::K_EOB;
using pass::K_LIT;
using pass::K_MATCH;
using pass::Sym;
using pass::TK_LIT;
using pass::TK_MATCH;
constexpr int TAB_LIT_LIM = 0, TAB_LIT_RD = 16, TAB_DIST_LIM = 32,
              TAB_DIST_RD = 48, TAB_SYM8 = 64, TAB_SYMHI = 136,
              TAB_DSYM8 = 145, TAB_OUTBASE = 155, TAB_W = 160;

// One lane's tables in shared memory: limits and rank offsets of the
// literal/length code [0] and the distance code [1], and rank -> symbol + 1
// (0 for a dead rank).
struct Tables {
  int lim[2][16], rd[2][16];
  short lit_sym[288];
  unsigned char dist_sym[32];
};

// Unpack the packed table t; every thread of the block calls it, and the
// caller synchronizes before reading.
__device__ __forceinline__ void load_tables(Tables& s, const int* t) {
  for (int r = threadIdx.x; r < 288; r += blockDim.x) {
    const unsigned lo = ((unsigned)t[TAB_SYM8 + (r >> 2)] >> ((r & 3) * 8)) & 0xFF;
    const unsigned hi = ((unsigned)t[TAB_SYMHI + (r >> 5)] >> (r & 31)) & 1;
    s.lit_sym[r] = (short)(lo | (hi << 8));
    if (r < 32) {
      s.dist_sym[r] =
          (unsigned char)(((unsigned)t[TAB_DSYM8 + (r >> 2)] >> ((r & 3) * 8)) & 0xFF);
    }
    if (r < 16) {
      s.lim[0][r] = t[TAB_LIT_LIM + r];
      s.rd[0][r] = t[TAB_LIT_RD + r];
      s.lim[1][r] = t[TAB_DIST_LIM + r];
      s.rd[1][r] = t[TAB_DIST_RD + r];
    }
  }
}

__device__ __forceinline__ int rev15(uint64_t w) {
  return (int)(__brev((unsigned)(w & 0x7FFF)) >> 17);
}

// The number of limits above v, counted as the JAX tokenizer does.
__device__ __forceinline__ int code_len(int v, const int* lim) {
  int cnt = 0;
#pragma unroll
  for (int L = 1; L < 16; ++L) cnt += v < lim[L];
  return 16 - cnt;
}

// The symbol whose code starts at bit 0 of w (at least 49 bits valid):
// kind, total width adv (1 for K_BAD), literal byte or match length,
// match distance.
__device__ __forceinline__ Sym dyn_symbol(uint64_t w, const int* lit_lim,
                                          const int* lit_rd,
                                          const short* lit_sym,
                                          const int* dist_lim,
                                          const int* dist_rd,
                                          const unsigned char* dist_sym) {
  Sym s{K_BAD, 1, 0, 0};
  const int v = rev15(w);
  const int nb = code_len(v, lit_lim);
  const int nbc = nb < 1 ? 1 : (nb > 15 ? 15 : nb);
  const int rank = (v >> (15 - nbc)) + lit_rd[nbc];
  if (nb > 15 || rank < 0 || rank >= 288) return s;
  const int symp1 = lit_sym[rank];
  if (symp1 == 0 || symp1 - 1 > 285) return s;
  const int sym = symp1 - 1;
  if (sym < 256) {
    s.kind = K_LIT;
    s.adv = nbc;
    s.ta = sym;
    return s;
  }
  if (sym == 256) {
    s.kind = K_EOB;
    s.adv = nbc;
    return s;
  }
  const int i = sym - 257;
  const int ebits = (i < 8 || i == 28) ? 0 : (i >> 2) - 1;
  const int lbase =
      i == 28 ? 258 : (i < 8 ? i + 3 : ((4 + (i & 3)) << ebits) + 3);
  const int length = lbase + (int)((w >> nbc) & ((1u << ebits) - 1));
  const int doff = nbc + ebits;
  const int dv = rev15(w >> doff);
  const int dnb = code_len(dv, dist_lim);
  const int dnbc = dnb < 1 ? 1 : (dnb > 15 ? 15 : dnb);
  const int drank = (dv >> (15 - dnbc)) + dist_rd[dnbc];
  if (dnb > 15 || drank < 0 || drank >= 32) return s;
  const int dsymp1 = dist_sym[drank];
  if (dsymp1 == 0) return s;
  const int dsym = dsymp1 - 1 > 29 ? 29 : dsymp1 - 1;
  const int debits = dsym < 2 ? 0 : (dsym >> 1) - 1;
  const int dbase = dsym < 2 ? dsym + 1 : ((2 + (dsym & 1)) << debits) + 1;
  s.kind = K_MATCH;
  s.adv = doff + dnbc + debits;
  s.ta = length;
  s.dist = dbase + (int)((w >> (doff + dnbc)) & ((1u << debits) - 1));
  return s;
}

}  // namespace dyn
