"""The dynamic trees of the dynamic-trees encode (``csrc/dyntrees.cu``).

For every lane: the literal/length count of each token start and the
distance count of each start whose symbol is a length code (257..285,
which is what makes a start a match), the end-of-block's 1, distance code
0 forced where the lane has no match; then each tree's length-limited
lengths, canonical codes (bit-reversed), the RFC 1951 3.2.7 run-length
header with its code-length tree, the Kraft checks, and the choice of
dynamic trees where header and tokens take fewer bits than the static
trees.  Returns what ``ops.encode._dynamic_trees_plain``, the plain
version, returns, which CPU tensors take (``ops.encode._dynamic_trees``
routes them there).
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.kernels import build

LIT, DIST, HDR = 288, 32, 340  # table widths of the outputs


def dyn_trees_batch(start: torch.Tensor, litlen_sym: torch.Tensor,
                    dsym: torch.Tensor):
    """(use_dyn bool[B], lit_code, lit_len int64[B, 288], dist_code,
    dist_len int64[B, 32], hdr_vals, hdr_nbs int64[B, 340]) of token
    starts start bool[B, N] with their symbols litlen_sym and dsym
    int64[B, N] (read at starts only), on the card: one launch, a block a
    lane.  Where a lane keeps static trees the tables are the static ones
    and the header widths 0."""
    if (start.dtype != torch.bool or litlen_sym.dtype != torch.int64
            or dsym.dtype != torch.int64):
        raise ValueError("dyn_trees_batch: expects bool start, int64 symbols")
    if start.dim() != 2 or litlen_sym.shape != start.shape or dsym.shape != start.shape:
        raise ValueError(
            f"dyn_trees_batch: shapes {tuple(start.shape)}, "
            f"{tuple(litlen_sym.shape)}, {tuple(dsym.shape)} differ or are not [B, N]")
    build.require_cuda("dyn_trees_batch", start, litlen_sym, dsym)
    B, N = start.shape
    dev = start.device
    use_dyn = torch.empty(B, dtype=torch.bool, device=dev)
    lit_code, lit_len = (torch.empty(B, LIT, dtype=torch.int64, device=dev)
                         for _ in range(2))
    dist_code, dist_len = (torch.empty(B, DIST, dtype=torch.int64, device=dev)
                           for _ in range(2))
    hdr_vals, hdr_nbs = (torch.empty(B, HDR, dtype=torch.int64, device=dev)
                         for _ in range(2))
    out = (use_dyn, lit_code, lit_len, dist_code, dist_len, hdr_vals, hdr_nbs)
    if B == 0:
        return out
    build.check(build.library().dyntrees_launch(
        start.data_ptr(), litlen_sym.data_ptr(), dsym.data_ptr(),
        *(t.data_ptr() for t in out), B, N, build.stream_handle(dev)), "dyntrees")
    dyn_trees_batch.launches += 1
    return out


dyn_trees_batch.launches = 0
