"""Decode stage 2: tokens -> output bytes (``csrc/expand3.cu``).

Inputs per lane, in the layout of ``tpu_deflate.kernels.expand3.
expand_fused3``: ``off`` each token's exclusive output offset, ``c1`` =
kind << 9 | (ta & 0x1FF), ``tb`` the match distance (or a stored block's
byte offset in ``rows``), ``tp`` the token count and ``total`` the output
length.  A token's length is the gap to the next token's offset (to
``total`` for the last one), so stored blocks longer than 511 bytes need
nothing beyond c1.  A match byte whose source lies before the row takes
byte 0's value, as in the JAX package.  Returns uint8[B, out_cap]: the
bytes, zero past total.  The kernel takes one thread block a lane, with
the row and a parent per byte in shared memory.
The JAX kernel returns the same values as int32 and takes no stored
tokens; here stored tokens copy from ``rows``.
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.kernels import build
from tpu_deflate_torch.kernels.resolve import resolve_roots_plain

MAX_OUT_CAP = 1 << 16  # the output row lives in one block's shared memory


def expand_fused3_plain(rows, off, c1, tb, tp, total, out_cap: int):
    """Plain version: per-byte fields, then pointer-doubling resolution."""
    # ops.expand imports this module, so its fields are looked up at call time
    from tpu_deflate_torch.ops.expand import _expand_fields

    val, parent, in_range = _expand_fields(rows, off, c1, tb, tp, total,
                                           out_cap)
    root = resolve_roots_plain(parent, val)
    return torch.where(in_range, root, 0).to(torch.uint8)


def expand_fused3(rows: torch.Tensor, off: torch.Tensor, c1: torch.Tensor,
                  tb: torch.Tensor, tp: torch.Tensor, total: torch.Tensor,
                  out_cap: int) -> torch.Tensor:
    """Expand each lane's tokens into uint8[B, out_cap].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if off.device.type == "cpu":
        return expand_fused3_plain(rows, off, c1, tb, tp, total, out_cap)
    if not 1 <= out_cap <= MAX_OUT_CAP:
        raise ValueError(f"expand_fused3: out_cap {out_cap} outside "
                         f"[1, {MAX_OUT_CAP}]")
    if rows.dtype != torch.uint8 or any(
        t.dtype != torch.int32 for t in (off, c1, tb, tp, total)
    ):
        raise ValueError("expand_fused3: expects uint8 rows, int32 tokens")
    build.require_cuda("expand_fused3", rows, off, c1, tb, tp, total)
    B, K = off.shape
    M = rows.shape[1]
    out = torch.empty(B, out_cap, dtype=torch.uint8, device=off.device)
    if B == 0:
        return out
    if M == 0:
        raise ValueError("expand_fused3: rows must hold at least one byte")
    code = build.library().expand3_launch(
        rows.data_ptr(), off.data_ptr(), c1.data_ptr(), tb.data_ptr(),
        tp.data_ptr(), total.data_ptr(), out.data_ptr(), B, K, M, out_cap,
        build.stream_handle(off.device),
    )
    build.check(code, "expand3")
    expand_fused3.launches += 1
    return out


expand_fused3.launches = 0
