"""Segmented expansion of one long stream's tokens.

Tokens are ordered with known output offsets and back-references reach at
most 32 KiB, so a stream of any length expands in segments of whole
tokens of about SEG output bytes: segment k holds the tokens whose
offsets lie in [k * SEG, (k + 1) * SEG), so its output starts at a ragged
base within 258 bytes (65535 after a stored block) of k * SEG, and a token
that crosses a boundary belongs to the segment where it starts.  Each
segment expands through ``ops.expand.expand_batch`` with the previous
32 KiB of output prepended as literal tokens, at one fixed row length (a
multiple of 2048 under 2^20): a segment without stored tokens launches
``expand_fused2`` with distances up to 32768, one with a stored token
``resolve_roots``.  The counterpart of ``tpu_deflate.ops.foreign.
_expand_segments``, with a host loop over the segments.
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.kernels.tokenize import TK_LIT
from tpu_deflate_torch.ops.expand import OTILE, expand_batch

SEG = 1 << 19  # output bytes per expansion segment
WIN = 1 << 15  # RFC window carried between segments
# a segment's row: the window, SEG bytes, and the longest emission past
# the boundary (a stored token's 65535 bytes; a match's only 258)
SLAB = SEG + 65536 + 512
SEG_CAP = -(-(WIN + SLAB) // OTILE) * OTILE


def expand_segments(data: torch.Tensor, tk: torch.Tensor, ta: torch.Tensor,
                    tb: torch.Tensor, out_total: int) -> torch.Tensor:
    """data uint8[M] (stored tokens copy from it), tk, ta, tb int32[K] live
    tokens producing out_total bytes -> uint8[out_total]."""
    dev = tk.device
    n = torch.where(tk == TK_LIT, 1, ta).to(torch.int64)
    off = torch.cumsum(n, 0) - n
    nseg = -(-out_total // SEG)
    edges = torch.searchsorted(
        off, SEG * torch.arange(nseg + 1, device=dev), right=False)
    lo = edges.tolist()
    bases = torch.cat([off, off.new_tensor([out_total])])[edges].tolist()
    out = torch.zeros(out_total, dtype=torch.uint8, device=dev)
    zeros = torch.zeros(WIN, dtype=torch.int32, device=dev)
    window = zeros
    rows = data[None]
    for k in range(nseg):
        base, nxt = bases[k], bases[k + 1]
        sl = slice(lo[k], lo[k + 1])
        if k:  # the output just before this segment, as literal tokens
            window = out[base - WIN : base].to(torch.int32)
        tk2 = torch.cat([zeros, tk[sl]])[None]
        ta2 = torch.cat([window, ta[sl]])[None]
        tb2 = torch.cat([zeros, tb[sl]])[None]
        tp2 = torch.tensor([tk2.shape[1]], dtype=torch.int32, device=dev)
        seg, _ = expand_batch(rows, tk2, ta2, tb2, tp2, SEG_CAP)
        out[base:nxt] = seg[0, WIN : WIN + nxt - base]
    return out
