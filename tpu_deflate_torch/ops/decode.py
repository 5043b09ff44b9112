"""Chunk-parallel decode of the indexed container: stage 1 tokenizes each
lane's bitstream (``kernels/tokenize.py``), stage 2 expands the tokens
into bytes (``kernels/expand3.py``).  Also the reachability chase shared
with the encoder's greedy parse.
"""

from __future__ import annotations

import math

import torch

from tpu_deflate_torch.kernels.expand3 import expand_fused3
from tpu_deflate_torch.kernels.tokenize import (
    ERR_BAD_CODE,
    ERR_DIST,
    ERR_DYNAMIC,
    ERR_INPUT,
    ERR_METHOD,
    ERR_OVERFLOW,
    ERR_STORED,
    TK_LIT,
    TK_MATCH,
    TK_STORED,
    tokenize_static_batch,
)

ERR_NAMES = {
    ERR_METHOD: "bad block method",
    ERR_BAD_CODE: "invalid Huffman code",
    ERR_DIST: "back-reference distance before stream start",
    ERR_OVERFLOW: "token capacity exceeded",
    ERR_STORED: "malformed stored block",
    ERR_INPUT: "truncated stream (ran past end without EOB)",
    ERR_DYNAMIC: "dynamic-Huffman block",
}


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


def _expand_fields(rows, off, c1, tb, tp, total, out_cap: int):
    """Per output byte: (val, parent, in_range), int64 / bool[B, out_cap].

    A byte's owner is the last live token whose offset is at or before
    it.  Literal and stored bytes are their own parents and carry their
    value; a match byte's parent is the byte it copies."""
    B, K = off.shape
    M = rows.shape[1]
    dev = off.device
    i64 = torch.int64
    tok = torch.arange(K, device=dev)
    off = off.to(i64)
    live = tok < tp[:, None]
    start = torch.where(live & (off < out_cap), off, out_cap)
    owner = torch.full((B, out_cap + 1), -1, dtype=i64, device=dev)
    owner = owner.scatter_reduce(1, start, tok.expand(B, K), "amax")
    owner = torch.cummax(owner[:, :out_cap], dim=1).values
    filled = owner >= 0
    own = owner.clamp_min(0)
    c = torch.gather(c1.to(i64), 1, own)
    b = torch.gather(tb.to(i64), 1, own)
    j = torch.arange(out_cap, device=dev) - torch.gather(off, 1, own)
    kind = (c >> 9) & 3
    in_range = (torch.arange(out_cap, device=dev) < total[:, None]) & filled

    stored = torch.gather(rows.to(i64), 1, (b + j).clamp(0, M - 1))
    val = torch.where(kind == TK_LIT, c & 0x1FF,
                      torch.where(kind == TK_STORED, stored, 0))
    p = torch.arange(out_cap, device=dev).expand(B, out_cap)
    is_m = in_range & (kind == TK_MATCH)
    parent = torch.where(is_m, (p - b).clamp(0, out_cap - 1), p)
    return val, parent, in_range


def _expand_inputs(tk, ta, tp):
    """The expand kernel's token layout: (off, c1, total) int32."""
    live = torch.arange(tk.shape[1], device=tk.device) < tp[:, None]
    n = torch.where(live, torch.where(tk == TK_LIT, 1, ta), 0)
    off = (torch.cumsum(n, 1) - n).to(torch.int32)
    c1 = (((tk & 3) << 9) | (ta & 0x1FF)).to(torch.int32)
    return off, c1, n.sum(1).to(torch.int32)


def expand_batch(rows, tk, ta, tb, tp, out_cap: int):
    """Stage 2 over chunk lanes: token arrays -> (uint8[B, out_cap] bytes,
    zero past each lane's total, int32[B] totals)."""
    off, c1, total = _expand_inputs(tk, ta, tp)
    return expand_fused3(rows, off, c1, tb, tp, total, out_cap), total


def chunk_pwin(chunk: int) -> int:
    """Bit positions per tokenizer pass for chunk-parallel decode: 17 * 2^k
    (the JAX package's plane window, which fixes where its passes split
    and so which error a pass reports)."""
    k = max(6, min(14, math.ceil(math.log2(max(chunk, 64))) - 2))
    return 17 << k


def decode_rows_batch(rows: torch.Tensor, ends: torch.Tensor, out_cap: int,
                      tok_cap: int):
    """Chunk-parallel decode of per-lane rows uint8[B, M], each one
    byte-aligned run of stored / static blocks ending at bit ends[b].
    Lanes stop at their first end-of-block.  Returns (out uint8[B,
    out_cap], totals int32[B], errs int32[B])."""
    ends = ends.to(torch.int32)
    tk, ta, tb, tp, _tot, _pos, err = tokenize_static_batch(
        rows, ends, tok_cap, chunk_pwin(out_cap)
    )
    out, total = expand_batch(rows, tk, ta, tb, tp, out_cap)
    return out, total, err
