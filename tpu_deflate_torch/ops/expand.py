"""Decode stage 2: token arrays -> output bytes, routed between the three
expansion kernels (``kernels/expand3.py`` for rows up to 2^16 bytes,
``kernels/expand2.py`` above, ``kernels/resolve.py`` for long rows with
stored tokens), as ``tpu_deflate.ops.decode.expand_batch`` routes them.
``ops.decode`` uses it for chunk lanes and short streams, ``ops.foreign``
for the segments of a long stream.
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.kernels.expand2 import MAX_OUT_CAP as MAX_OUT_CAP2
from tpu_deflate_torch.kernels.expand2 import expand_fused2
from tpu_deflate_torch.kernels.expand3 import MAX_OUT_CAP as MAX_OUT_CAP3
from tpu_deflate_torch.kernels.expand3 import expand_fused3
from tpu_deflate_torch.kernels.resolve import resolve_roots
from tpu_deflate_torch.kernels.tokenize import TK_LIT, TK_MATCH, TK_STORED
from tpu_deflate_torch.utils.profiling import tally

OTILE = 2048  # expand_fused2 takes rows whose length is a multiple of this


def pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


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
    zero past each lane's total, int32[B] totals).

    Rows up to 2^16 bytes take ``expand_fused3``, stored tokens included.
    Above that, a batch with a live stored token, or a row length that
    ``expand_fused2`` does not take, goes through the per-byte fields and
    ``resolve_roots``; every other batch through ``expand_fused2``."""
    off, c1, total = _expand_inputs(tk, ta, tp)
    if out_cap <= MAX_OUT_CAP3:
        return expand_fused3(rows, off, c1, tb, tp, total, out_cap), total
    live = torch.arange(tk.shape[1], device=tk.device) < tp[:, None]
    with tally("d2h"):
        any_stored = bool(((tk == TK_STORED) & live).any())
    if not any_stored and out_cap % OTILE == 0 and out_cap <= MAX_OUT_CAP2:
        return expand_fused2(off, c1, tb, tp, total, out_cap), total
    val, parent, in_range = _expand_fields(rows, off, c1, tb, tp, total,
                                           out_cap)
    root = resolve_roots(parent.to(torch.int32), val.to(torch.int32))
    return torch.where(in_range, root, 0).to(torch.uint8), total


def expand(data, tk, ta, tb, tp: int, out_cap: int):
    """Single-stream stage 2: data uint8[M], tk, ta, tb int32[K] and the
    token count -> (uint8[out_cap], total); see ``expand_batch``."""
    with tally("h2d"):
        tpt = torch.tensor([tp], dtype=torch.int32, device=tk.device)
    out, total = expand_batch(data[None], tk[None], ta[None], tb[None], tpt,
                              out_cap)
    with tally("d2h"):
        return out[0], int(total[0])
