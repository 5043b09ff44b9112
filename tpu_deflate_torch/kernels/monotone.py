"""Multi-channel scatter-adds (``csrc/monotone.cu``).

    out[b, c, j] = sum of vals[b, c, e] over every e with idx[b, e] == j

Entries with idx outside [0, size) drop out.  Two kernels compute it:

  mono_scatter_add  the encoder's bit-pack (bit offsets / 8).  Both the
                    TPU kernel and the CUDA kernel rely on the indices'
                    order (see its docstring).  The output of
                    ``tpu_deflate.kernels.monotone.mono_scatter_add``.
  mono_compact      the decoder's code-length paint, a small output per
                    lane.  The output of
                    ``tpu_deflate.kernels.monotone.mono_compact`` on each
                    lane, which takes live indices nondecreasing and
                    advancing by at most one per entry; the CUDA kernel
                    does not need it.
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.kernels import build

_SLAB = 2048  # entries a block of the bit-pack (kPackSlab in csrc/monotone.cu)


def mono_scatter_add_plain(idx: torch.Tensor, vals: torch.Tensor,
                           size: int) -> torch.Tensor:
    """Plain version: one masked ``scatter_add`` per batch."""
    B, C, K = vals.shape
    drop = (idx < 0) | (idx >= size)
    tgt = torch.where(drop, 0, idx).to(torch.int64)
    v = torch.where(drop[:, None, :], 0, vals).to(torch.int32)
    out = torch.zeros(B, C, size, dtype=torch.int32, device=vals.device)
    return out.scatter_add_(2, tgt[:, None, :].expand(B, C, K), v)


def mono_scatter_add(idx: torch.Tensor, vals: torch.Tensor,
                     size: int) -> torch.Tensor:
    """idx int32[B, K], vals int32[B, C, K] -> int32[B, C, size].

    Precondition, as the TPU kernel's: in each lane the live indices (those
    in [0, size)) are nondecreasing; dead entries carry an index < 0 before
    the first live one (the head) or >= size after the last (the tail), and
    drop out.  The encoder's indices, bit offsets / 8 of an exclusive
    cumsum, meet it.  It is not checked: that would need a read back to
    the host.  The plain version takes any indices.

    CPU tensors take the plain version; CUDA tensors launch the kernel (two
    launches: the sums of runs that cross a slab of 2048 entries into a
    scratch of B * ceil(K / 2048) * C words, then the pack), which writes
    every element of the output."""
    if idx.device.type == "cpu":
        return mono_scatter_add_plain(idx, vals, size)
    if idx.dtype != torch.int32 or vals.dtype != torch.int32:
        raise ValueError("mono_scatter_add: expects int32 idx and vals")
    build.require_cuda("mono_scatter_add", idx, vals)
    B, C, K = vals.shape
    if idx.shape != (B, K):
        raise ValueError(f"mono_scatter_add: idx {tuple(idx.shape)} vs "
                         f"vals {tuple(vals.shape)}")
    out = torch.empty(B, C, size, dtype=torch.int32, device=vals.device)
    if out.numel() == 0:
        return out
    lead = torch.empty(B, -(-K // _SLAB), C, dtype=torch.int32, device=vals.device)
    code = build.library().mono_scatter_add_launch(
        idx.data_ptr(), vals.data_ptr(), lead.data_ptr(), out.data_ptr(), B, C,
        K, size, build.stream_handle(idx.device),
    )
    build.check(code, "mono_scatter_add")
    mono_scatter_add.launches += 1
    return out


mono_scatter_add.launches = 0


def mono_compact_plain(idx: torch.Tensor, vals: torch.Tensor,
                       size: int) -> torch.Tensor:
    """Plain version: the same masked ``scatter_add`` as the bit-pack's."""
    return mono_scatter_add_plain(idx, vals, size)


def mono_compact(idx: torch.Tensor, vals: torch.Tensor,
                 size: int) -> torch.Tensor:
    """idx int32[B, K], vals int32[B, C, K] -> int32[B, C, size], with
    C * size * 4 bytes at most 48 KiB (the kernel's accumulator in shared
    memory; a larger one fails its launch).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which writes every element of the output."""
    if idx.device.type == "cpu":
        return mono_compact_plain(idx, vals, size)
    if idx.dtype != torch.int32 or vals.dtype != torch.int32:
        raise ValueError("mono_compact: expects int32 idx and vals")
    build.require_cuda("mono_compact", idx, vals)
    B, C, K = vals.shape
    if idx.shape != (B, K):
        raise ValueError(f"mono_compact: idx {tuple(idx.shape)} vs "
                         f"vals {tuple(vals.shape)}")
    if B * K == 0:
        return torch.zeros(B, C, size, dtype=torch.int32, device=vals.device)
    out = torch.empty(B, C, size, dtype=torch.int32, device=vals.device)
    code = build.library().mono_compact_launch(
        idx.data_ptr(), vals.data_ptr(), out.data_ptr(), B, C, K, size,
        build.stream_handle(idx.device),
    )
    build.check(code, "mono_compact")
    mono_compact.launches += 1
    return out


mono_compact.launches = 0
