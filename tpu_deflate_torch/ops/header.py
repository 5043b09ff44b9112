"""The dynamic block header: canonical code parameters of a set of code
lengths, the code lengths themselves from a header's code-length codes,
and the packed table that the dynamic tokenizers read
(``kernels/tokenize_dyn.py``).  Also the reachability chase that the
code-length parse shares with the encoder's greedy parse.  Used by the
chunk-lane decoder and the block walk (``ops/decode.py``) and by the
device-paced stream decode (``ops/foreign.py``).
"""

from __future__ import annotations

import math

import torch

from tpu_deflate_torch.kernels.monotone import mono_compact
from tpu_deflate_torch.kernels.tokenize import bit_windows
from tpu_deflate_torch.kernels.tokenize_dyn import TAB_W, code_rank, rev15


def chase_reach(adv: torch.Tensor, term: torch.Tensor) -> torch.Tensor:
    """Positions reachable from index 0 under next[p] = p + adv[p].

    adv: int[..., P] jumps >= 1; term: bool[..., P] chain terminators (the
    chain stops AT a terminal position, which is still reached).  Returns
    bool[..., P].  Pointer doubling: after round k every position within
    2^k steps of 0 is marked."""
    P = adv.shape[-1]
    lead = adv.shape[:-1]
    idx = torch.arange(P, device=adv.device, dtype=torch.int64)
    nxt = torch.where(term, P, (idx + adv).clamp(max=P))
    # column P is the sink for chains that end or leave the range
    jump = torch.cat([nxt, torch.full((*lead, 1), P, dtype=torch.int64,
                                      device=adv.device)], dim=-1)
    reach = torch.zeros((*lead, P + 1), dtype=torch.int32, device=adv.device)
    reach[..., 0] = 1
    for _ in range(math.ceil(math.log2(P + 1)) + 1):
        reach = reach.scatter_reduce(-1, jump, reach, "amax")
        jump = torch.gather(jump, -1, jump)
    return reach[..., :P].bool()


MAX_SYMS = 320  # 288 literal/length + 32 distance code lengths
CL_WIN = 4608  # bits searched for the code lengths: <= 316 lengths, each
# op <= 7 (code-length code) + 7 (repeat extra) bits, < 4424 bits in all


def canon_params(lengths: torch.Tensor, n_sym: int):
    """Comparison-decode parameters of canonical codes with lengths
    int64[B, S]: (lim, rd int64[B, 16], sym int64[B, n_sym] = the symbol
    of each rank, -1 for a dead rank, oversubscribed bool[B]).

    A code of length L has an MSB-first 15-bit prefix v with lim[L-1] <= v
    < lim[L], lim[L] = (next_code[L] + count[L]) << (15 - L) made
    nondecreasing, and rank (v >> (15 - L)) + rd[L], rd[L] = (codes shorter
    than L) - next_code[L]."""
    B, S = lengths.shape
    dev = lengths.device
    i64 = torch.int64
    valid = (lengths > 0) & (lengths <= 15)
    Lc = lengths.clamp(0, 15)
    # count[0] stays 0: a length outside [1, 15] adds nothing
    count = torch.zeros(B, 16, dtype=i64, device=dev).scatter_add(
        1, Lc, valid.to(i64))
    # next_code[L] = (next_code[L - 1] + count[L - 1]) << 1, unrolled: the
    # sum over k < L of count[k] << (L - k)
    ln = torch.arange(16, device=dev)
    gap = ln[:, None] - ln
    next_code = torch.where(gap > 0, count[:, None, :] << gap.clamp(min=0), 0).sum(2)
    before = torch.cumsum(count, 1) - count
    lim = torch.where(ln > 0, (next_code + count) << (15 - ln), 0)
    lim = torch.cummax(lim, 1).values
    rd = before - next_code
    kraft = torch.where(valid, 1 << (15 - Lc), 0).sum(1)
    # rank: codes shorter, then codes of the same length at a smaller symbol
    eq = (Lc[:, None, :] == ln[1:, None]) & valid[:, None, :]
    within = torch.where(eq, torch.cumsum(eq, 2) - eq.to(i64), 0).sum(1)
    rank = torch.gather(before, 1, Lc) + within
    slot = torch.where(valid & (rank < n_sym), rank, n_sym)
    sym = torch.full((B, n_sym + 1), -1, dtype=i64, device=dev).scatter(
        1, slot, torch.arange(S, device=dev).expand(B, S))
    return lim, rd, sym[:, :n_sym], kraft > (1 << 15)


def decode_cl_lengths(rows: torch.Tensor, pos0: torch.Tensor,
                      target: torch.Tensor, cl_lim, cl_rd, cl_sym,
                      win: int = CL_WIN, reach_fn=chase_reach):
    """The HLIT + HDIST code lengths of each lane's dynamic header, from
    rows int64[B, L] (zero bytes after the data) at bit pos0 int64[B]:
    (lengths int64[B, MAX_SYMS], end_next int64[B] = bit offset from pos0
    of the first symbol after the header, -1 if the lengths do not end on
    a symbol, ok bool[B]).

    A code-length symbol is decoded at each of the ``win`` positions, the
    true ones are those reachable from the first (``reach_fn(adv, term)``
    -> bool[B, win]), the repeats of code 16 read the previous length by a
    forward fill, and each op's run of lengths is painted from its start by
    ``mono_compact`` (the op starts are strictly increasing) and filled
    forward."""
    B = rows.shape[0]
    dev = rows.device
    i64 = torch.int64
    bits = bit_windows(rows, pos0, win)
    nb, nbc, rank = code_rank(rev15(bits), cl_lim, cl_rd)
    sym = torch.gather(cl_sym, 1, rank.clamp(0, 18))
    bad = (nb > 7) | (rank < 0) | (rank > 18) | (sym < 0)
    x7 = (bits >> nbc) & 0x7F
    ebits = torch.where(sym == 16, 2, torch.where(sym == 17, 3,
                        torch.where(sym == 18, 7, 0)))
    count = torch.where(sym < 16, 1, torch.where(
        sym == 16, 3 + (x7 & 3),
        torch.where(sym == 17, 3 + (x7 & 7), 11 + x7)))
    adv = torch.where(bad, 1, nbc + ebits)
    sym = torch.where(bad, -1, sym)
    term = sym < 0
    reached = reach_fn(adv, term)

    pidx = torch.arange(win, device=dev)
    opc = torch.where(reached & ~term, count, 0)
    cum = torch.cumsum(opc, 1)
    cum_ex = cum - opc
    live = reached & ~term & (cum_ex < target[:, None])
    total = torch.where(live, cum, 0).amax(1)
    end_next = torch.where(live & (cum == target[:, None]), pidx + adv,
                           -1).amax(1)

    # code 16 repeats the previous length: the last literal length or zero
    # run before it, found by a running max of (position, value + 1)
    setk = torch.where(live & (sym < 16), (pidx << 9) | (sym + 1),
                       torch.where(live & (sym >= 17), (pidx << 9) | 1, -1))
    fill = torch.cummax(setk, 1).values
    bad16 = (live & (sym == 16) & (fill < 0)).any(1)
    assign = torch.where(sym < 16, sym,
                         torch.where(sym == 16, (fill & 0x1FF) - 1, 0))

    # paint (start, value + 1) at each op's first length, +1 so that an
    # empty slot reads 0, in two 14-bit channels
    q = torch.where(live, ((cum_ex << 9) | (assign + 1)) + 1, 0)
    idx = torch.where(live, cum_ex, MAX_SYMS).to(torch.int32)
    ch = torch.stack([q & 0x3FFF, q >> 14], 1).to(torch.int32)
    comp = mono_compact(idx, ch, MAX_SYMS).to(i64)
    arr = comp[:, 0] + (comp[:, 1] << 14) - 1
    farr = torch.cummax(arr, 1).values
    sidx = torch.arange(MAX_SYMS, device=dev)
    lengths = torch.where((sidx < target[:, None]) & (farr >= 0),
                          (farr & 0x1FF) - 1, 0)
    ok = (total == target) & ~bad16 & (end_next >= 0)
    return lengths, end_next, ok


def _pack_fields(v: torch.Tensor, per: int, bits: int) -> torch.Tensor:
    """``per`` consecutive ``bits``-bit values of v int64[B, K] per int32
    (two's complement), K % per == 0."""
    B, K = v.shape
    sh = bits * torch.arange(per, device=v.device)
    w = (v.reshape(B, K // per, per) << sh).sum(2)
    return ((w + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def pack_block_tab(lit_lengths: torch.Tensor, dist_lengths: torch.Tensor,
                   start: torch.Tensor, out_base: torch.Tensor | None = None):
    """Packed code tables of one block per lane, from lit_lengths int64[B,
    288], dist_lengths int64[B, 32], the first symbol's bit start[B] and
    the output bytes before the block out_base[B] (default none): (tab
    int64[B, TAB_W] in the ``kernels.tokenize_dyn`` layout, min_len
    int64[B] = the shortest literal/length code, trees_ok bool[B] =
    neither tree oversubscribed)."""
    B = lit_lengths.shape[0]
    dev = lit_lengths.device
    if out_base is None:
        out_base = torch.zeros(B, dtype=torch.int64, device=dev)
    # both trees in one call: the distance lengths padded with zeros, of
    # which the first 32 ranks are those of their own 32 symbols
    dpad = torch.nn.functional.pad(dist_lengths, (0, 288 - dist_lengths.shape[1]))
    lim, rd, sym, over = canon_params(torch.cat([lit_lengths, dpad]), 288)
    llim, lrd, lsym, lover = lim[:B], rd[:B], sym[:B], over[:B]
    dlim, drd, dsym, dover = lim[B:], rd[B:], sym[B:, :32], over[B:]
    min_len = torch.where(lit_lengths > 0, lit_lengths, 99).amin(1)
    symp1 = torch.where((lsym >= 0) & (lsym <= 287), lsym + 1, 0)
    dsymp1 = torch.where((dsym >= 0) & (dsym <= 29), dsym + 1, 0)
    tab = torch.cat([
        llim, lrd, dlim, drd,
        _pack_fields(symp1 & 0xFF, 4, 8), _pack_fields(symp1 >> 8, 32, 1),
        _pack_fields(dsymp1, 4, 8), start[:, None], min_len[:, None],
        out_base[:, None], torch.zeros(B, 4, dtype=torch.int64, device=dev),
    ], 1)
    assert tab.shape[1] == TAB_W
    return tab, min_len, ~lover & ~dover
