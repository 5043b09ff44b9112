"""Decode stage 2 for long rows: tokens -> output bytes
(``csrc/expand2.cu``).

The token layout of ``kernels.expand3`` (``off``, ``c1``, ``tb``, ``tp``,
``total``) for rows above that kernel's 2^16 bytes: out_cap up to 2^20,
match distances up to the RFC window of 32768 (the kernel takes any), and
no stored tokens, as ``tpu_deflate.kernels.expand2.expand_fused2``: a
batch with a stored token goes through ``kernels.resolve``.  Returns
uint8[B, out_cap]: the bytes, zero past total (the JAX kernel returns the
same values as int32).  The kernel expands the row in output tiles of
``TILE`` bytes in one launch; ``sync`` holds its ticket counter and a
flag a tile, zeroed by the launcher, and ``chains`` the table of each
byte's value or earlier position through which tiles resolve bytes
copied from earlier tiles.
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.kernels import build
from tpu_deflate_torch.kernels.expand3 import expand_fused3_plain

MAX_OUT_CAP = 1 << 20
TILE = 8192  # csrc/expand2.cu's kTile: output bytes a block expands


def expand_fused2_plain(off, c1, tb, tp, total, out_cap: int):
    """Plain version: ``expand_fused3_plain`` over an empty input row, so
    that a stored token's bytes read as zero."""
    rows = torch.zeros(off.shape[0], 1, dtype=torch.uint8, device=off.device)
    return expand_fused3_plain(rows, off, c1, tb, tp, total, out_cap)


def expand_fused2(off: torch.Tensor, c1: torch.Tensor, tb: torch.Tensor,
                  tp: torch.Tensor, total: torch.Tensor,
                  out_cap: int) -> torch.Tensor:
    """Expand each lane's literal and match tokens into uint8[B, out_cap].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if off.device.type == "cpu":
        return expand_fused2_plain(off, c1, tb, tp, total, out_cap)
    if not 1 <= out_cap <= MAX_OUT_CAP:
        raise ValueError(f"expand_fused2: out_cap {out_cap} outside "
                         f"[1, {MAX_OUT_CAP}]")
    if any(t.dtype != torch.int32 for t in (off, c1, tb, tp, total)):
        raise ValueError("expand_fused2: expects int32 tokens")
    build.require_cuda("expand_fused2", off, c1, tb, tp, total)
    B, K = off.shape
    if c1.shape != (B, K) or tb.shape != (B, K) or tp.shape != (B,) \
            or total.shape != (B,):
        raise ValueError("expand_fused2: token arrays differ in shape")
    dev = off.device
    out = torch.empty(B, out_cap, dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    sync = torch.empty(1 + B * -(-out_cap // TILE), dtype=torch.int32,
                       device=dev)
    chains = torch.empty(B, out_cap, dtype=torch.int32, device=dev)
    code = build.library().expand2_launch(
        off.data_ptr(), c1.data_ptr(), tb.data_ptr(), tp.data_ptr(),
        total.data_ptr(), out.data_ptr(), sync.data_ptr(), sync.numel(),
        chains.data_ptr(), B, K, out_cap, build.stream_handle(dev),
    )
    build.check(code, "expand2")
    expand_fused2.launches += 1
    return out


expand_fused2.launches = 0
