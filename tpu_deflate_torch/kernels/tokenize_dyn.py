"""Decode stage 1 for one static- or dynamic-tree block per lane, from
per-lane code tables (``csrc/tokenize_dyn.cu``).

The header of each lane's block is parsed beforehand
(``ops.decode.dyn_header_params_batch``), which packs the lane's canonical
code parameters into a table of TAB_W int32 (layout below, that of
``tpu_deflate.kernels.tokenize_dyn``) and gives the bit where its first
symbol starts.  A symbol is decoded by comparison: its code length is the
first L whose limit lim[L] exceeds the 15-bit MSB-first prefix, its rank
is prefix >> (15 - L) plus rd[L], and the rank names the symbol.

Inputs per lane: rows uint8[B, M], end_bits int32[B], tab int32[B,
TAB_W], starts int32[B], status int32[B] and tok0 int32[B].  The block
may follow earlier blocks of the lane (stored ones): tok0 tokens and
tab[TAB_OUTBASE] output bytes came before it, its tokens take the slots
from tok0 on, matches may reach into that output, and ntok and out_total
count it.  A lane with status < 0 is decoded from bit starts[b]; a lane
with status >= 0 ended in its header and reports err = status, no new
tokens and end_pos = starts[b].  Outputs are those of
``kernels.tokenize.tokenize_static_batch``, the result of
``tpu_deflate.ops.decode.tokenize(static_only=False, stop_at_eob=True)``
on each lane, decoded in passes of ``pwin`` bit positions with the same
error precedence (ERR_OVERFLOW, ERR_DIST, ERR_BAD_CODE within a pass).
``into`` = (tk, ta, tb) int32[B, tok_cap] holds the lane's earlier tokens;
the block's tokens are added to them (the kernel writes them in place).
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.kernels import build
from tpu_deflate_torch.kernels.tokenize import (
    K_BAD,
    K_EOB,
    K_LIT,
    K_MATCH,
    M_DONE,
    M_TOKENS,
    bit_windows,
    block_pass,
    finish,
    in_bounds,
    new_lanes,
)

# packed per-lane table layout
TAB_LIT_LIM = 0
TAB_LIT_RD = 16
TAB_DIST_LIM = 32
TAB_DIST_RD = 48
TAB_SYM8 = 64  # 72 rows: 4 x 8-bit low bytes of (sym + 1), 0 = dead rank
TAB_SYMHI = 136  # 9 rows: 32 x 1-bit bit 8 of (sym + 1)
TAB_DSYM8 = 145  # 8 rows: 4 x 8-bit (dsym + 1), 0 = dead rank
# then the first symbol's bit and the shortest literal/length code
TAB_OUTBASE = 155  # output bytes of the lane before the block
TAB_W = 160


def rank_symbols(tab: torch.Tensor):
    """The rank -> symbol tables of each lane's packed table: (lit int64[B,
    288], dist int64[B, 32]) holding sym + 1, 0 for a dead rank."""
    t = tab.to(torch.int64) & 0xFFFFFFFF
    dev = tab.device
    r = torch.arange(288, device=dev)
    lo = (t[:, TAB_SYM8 + (r >> 2)] >> ((r & 3) << 3)) & 0xFF
    hi = (t[:, TAB_SYMHI + (r >> 5)] >> (r & 31)) & 1
    d = torch.arange(32, device=dev)
    dist = (t[:, TAB_DSYM8 + (d >> 2)] >> ((d & 3) << 3)) & 0xFF
    return lo | (hi << 8), dist


def rev15(x: torch.Tensor) -> torch.Tensor:
    """The low 15 bits of x, MSB first: bit-reversed."""
    x = x & 0x7FFF
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 1


def code_rank(prefix: torch.Tensor, lim: torch.Tensor, rd: torch.Tensor):
    """Comparison decode of MSB-first 15-bit prefixes int64[S, P] against
    each row's (lim, rd) int64[S, 16]: (code length, 16 where no code
    matches; the length clipped to [1, 15]; rank)."""
    cnt = torch.zeros_like(prefix)
    for L in range(1, 16):
        cnt += prefix < lim[:, L : L + 1]
    nb = 16 - cnt
    nbc = nb.clamp(1, 15)
    return nb, nbc, (prefix >> (15 - nbc)) + torch.gather(rd, 1, nbc)


def _dyn_plane(rows, base, end, pwin: int, tab, lit_sym, dist_sym):
    """Candidate symbol at each of the pwin bit positions after base under
    each lane's tables: (kind, adv, ta, tb) int64[S, pwin].  adv is the
    symbol's total width (1 for K_BAD); positions at or past end are
    K_BAD."""
    dev = rows.device
    bits = bit_windows(rows, base, pwin)
    t = tab.to(torch.int64)

    def field(shift, nbits):
        return (bits >> shift) & ((1 << nbits) - 1)

    nb, nbc, rank = code_rank(rev15(bits), t[:, TAB_LIT_LIM : TAB_LIT_LIM + 16],
                              t[:, TAB_LIT_RD : TAB_LIT_RD + 16])
    symp1 = torch.gather(lit_sym, 1, rank.clamp(0, 287))
    bad = (nb > 15) | (rank < 0) | (rank >= 288) | (symp1 == 0)
    sym = (symp1 - 1).clamp(0, 287)
    is_lit = sym < 256
    is_eob = sym == 256
    bad |= sym > 285
    i = (sym - 257).clamp(0, 28)
    ebits = ((i >> 2) - 1).clamp(0, 5)
    lbase = torch.where(i < 8, i + 3, ((4 + (i & 3)) << ebits) + 3)
    lbase = torch.where(i == 28, 258, lbase)
    ebits = torch.where(i == 28, 0, ebits)
    is_m = ~is_lit & ~is_eob & ~bad
    ebits = torch.where(is_m, ebits, 0)
    length = lbase + (field(nbc, 5) & ((1 << ebits) - 1))

    doff = nbc + ebits
    dnb, dnbc, drank = code_rank(rev15(bits >> doff),
                                 t[:, TAB_DIST_LIM : TAB_DIST_LIM + 16],
                                 t[:, TAB_DIST_RD : TAB_DIST_RD + 16])
    dsymp1 = torch.gather(dist_sym, 1, drank.clamp(0, 31))
    bad_d = (dnb > 15) | (drank < 0) | (drank >= 32) | (dsymp1 == 0)
    dsym = (dsymp1 - 1).clamp(0, 29)
    debits = ((dsym >> 1) - 1).clamp(0, 13)
    dbase = torch.where(dsym < 2, dsym + 1, ((2 + (dsym & 1)) << debits) + 1)
    dist = dbase + (field(doff + dnbc, 13) & ((1 << debits) - 1))

    kind = torch.where(is_lit, K_LIT, torch.where(is_eob, K_EOB, K_MATCH))
    oob = base[:, None] + torch.arange(pwin, device=dev) >= end[:, None]
    kind = torch.where(bad | (is_m & bad_d) | oob, K_BAD, kind)
    is_m = kind == K_MATCH
    adv = torch.where(is_m, nbc + ebits + dnbc + debits,
                      torch.where(kind == K_BAD, 1, nbc))
    ta = torch.where(kind == K_LIT, sym, torch.where(is_m, length, 0))
    return kind, adv, ta, torch.where(is_m, dist, 0)


def tokenize_dyn_plain(rows: torch.Tensor, end_bits: torch.Tensor,
                       tab: torch.Tensor, starts: torch.Tensor,
                       status: torch.Tensor, tok0: torch.Tensor,
                       tok_cap: int, pwin: int, into=None):
    """Plain version: the JAX package's block passes, vectorized over
    lanes; each pass decodes a candidate under the lane's tables at every
    bit position of its window and finds the true symbol starts with
    ``chase_reach``."""
    dev = rows.device
    B, M = rows.shape
    i64 = torch.int64
    ext = torch.nn.functional.pad(rows.to(i64), (0, pwin // 8 + 16))
    end = end_bits.to(i64)
    status = status.to(i64)
    lit_sym, dist_sym = rank_symbols(tab)
    st = new_lanes(B, tok_cap, dev)
    if into is not None:
        for k, buf in zip(("tk", "ta", "tb"), into):
            st[k][:, :tok_cap] = buf
    walk = status < 0
    st["pos"] = starts.to(i64).clone()
    st["tp"] = tok0.to(i64).clone()
    st["total"] = tab[:, TAB_OUTBASE].to(i64).clone()
    st["mode"] = torch.where(walk, M_TOKENS, M_DONE)
    st["err"] = torch.where(walk, 0, status)
    lanes = torch.arange(B, device=dev)

    # the first pass follows the header without a bounds check, as the
    # JAX package's block loop runs it in the header's iteration
    sel = walk
    while True:
        s = lanes[sel]
        if s.numel() == 0:
            break
        plane = _dyn_plane(ext[s], st["pos"][s], end[s], pwin, tab[s],
                           lit_sym[s], dist_sym[s])
        block_pass(st, s, plane, tok_cap)
        sel = (st["mode"] == M_TOKENS) & in_bounds(st, end, 8 * M, tok_cap)
    return finish(st, end, tok_cap)


def tokenize_dyn_batch(rows: torch.Tensor, end_bits: torch.Tensor,
                       tab: torch.Tensor, starts: torch.Tensor,
                       status: torch.Tensor, tok0: torch.Tensor,
                       tok_cap: int, pwin: int, into=None):
    """Tokenize rows uint8[B, M] up to end_bits int32[B] under the tables
    tab int32[B, TAB_W], from starts int32[B], for the lanes whose status
    int32[B] is negative, after tok0 int32[B] earlier tokens.

    Returns (tk, ta, tb, ntok, out_total, end_pos, err), see
    ``kernels.tokenize``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if rows.device.type == "cpu":
        return tokenize_dyn_plain(rows, end_bits, tab, starts, status,
                                  tok0, tok_cap, pwin, into)
    for name, x, dt in (("rows", rows, torch.uint8),
                        ("end_bits", end_bits, torch.int32),
                        ("tab", tab, torch.int32),
                        ("starts", starts, torch.int32),
                        ("status", status, torch.int32),
                        ("tok0", tok0, torch.int32)):
        if x.dtype != dt:
            raise ValueError(f"tokenize_dyn_batch: {name} is {x.dtype}, "
                             f"expected {dt}")
    build.require_cuda("tokenize_dyn_batch", rows, end_bits, tab, starts,
                       status, tok0)
    B, M = rows.shape
    if tab.shape != (B, TAB_W):
        raise ValueError(f"tokenize_dyn_batch: tab {tuple(tab.shape)}")
    dev = rows.device
    if into is None:
        tk, ta, tb = (torch.zeros(B, tok_cap, dtype=torch.int32, device=dev)
                      for _ in range(3))
    else:
        tk, ta, tb = into
        build.require_cuda("tokenize_dyn_batch", tk, ta, tb)
        if any(t.dtype != torch.int32 or t.shape != (B, tok_cap)
               for t in into):
            raise ValueError("tokenize_dyn_batch: into expects int32 "
                             "[B, tok_cap] token buffers")
    ntok, out_total, end_pos, err = (
        torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4)
    )
    if B == 0:
        return tk, ta, tb, ntok, out_total, end_pos, err
    code = build.library().tokenize_dyn_launch(
        rows.data_ptr(), end_bits.data_ptr(), tab.data_ptr(),
        starts.data_ptr(), status.data_ptr(), tok0.data_ptr(),
        tk.data_ptr(), ta.data_ptr(),
        tb.data_ptr(), ntok.data_ptr(), out_total.data_ptr(),
        end_pos.data_ptr(), err.data_ptr(), B, M, tok_cap, pwin,
        build.stream_handle(dev),
    )
    build.check(code, "tokenize_dyn")
    tokenize_dyn_batch.launches += 1
    return tk, ta, tb, ntok, out_total, end_pos, err


tokenize_dyn_batch.launches = 0
