"""LZ77 match search, stages 1+2 of the encoder (``csrc/match2.cu``).

For every position i of a lane: the nearest distance d in [1, window] whose
3 bytes at i - d equal the 3 bytes at i, then the match extended byte by
byte up to ``max_match``.  A position matches only when i + 3 <= n and
d <= i; the extension stops at n; lengths are clipped to n - i.  Returns
(dist, length) int32[B, N], zero where a position has no match — the
output of ``tpu_deflate.kernels.match2.match_bitplane_batch``.
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.kernels import build

MAX_WINDOW = 256


def match_bitplane_plain(data: torch.Tensor, n: torch.Tensor, window: int,
                         max_match: int):
    """Plain version: one 3-byte key compare per distance, nearest first,
    then a gather per extension step."""
    B, N = data.shape
    dev = data.device
    b = data.to(torch.int64)
    n = n.to(torch.int64)[:, None]
    idx = torch.arange(N, device=dev, dtype=torch.int64)
    b1 = torch.nn.functional.pad(b[:, 1:], (0, 1))
    b2 = torch.nn.functional.pad(b[:, 2:], (0, 2))
    key3 = b | (b1 << 8) | (b2 << 16)
    # a 3-byte window that crosses n gets a key of its own, and so does
    # every position before the lane: neither ever matches
    key3 = torch.where(idx + 3 <= n, key3, (1 << 24) + idx)
    before = -1 - torch.arange(window, 0, -1, device=dev, dtype=torch.int64)
    kpad = torch.cat([before.expand(B, window), key3], dim=1)
    best = torch.zeros(B, N, dtype=torch.int64, device=dev)
    for d in range(1, window + 1):
        hit = key3 == kpad[:, window - d : window - d + N]
        best = torch.where((best == 0) & hit, d, best)
    has = (best > 0) & (idx + 3 <= n)
    alive = has
    ext = torch.zeros(B, N, dtype=torch.int64, device=dev)
    for k in range(3, max_match):
        tgt = (idx + k).clamp(max=N - 1).expand(B, N)
        src = (idx + k - best).clamp(0, N - 1)
        same = torch.gather(b, 1, tgt) == torch.gather(b, 1, src)
        alive = alive & (idx + k < n) & same
        ext += alive
    length = torch.where(has, 3 + ext, 0)
    length = torch.minimum(length, (n - idx).clamp_min(0))
    dist = torch.where(has, best, 0)
    return dist.to(torch.int32), length.to(torch.int32)


def match_bitplane_batch(data: torch.Tensor, n: torch.Tensor, window: int,
                         max_match: int):
    """(dist, length) int32[B, N] of data uint8[B, N], n int32[B].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if data.device.type == "cpu":
        return match_bitplane_plain(data, n, window, max_match)
    if data.dtype != torch.uint8 or n.dtype != torch.int32:
        raise ValueError("match_bitplane_batch: expects uint8 data, int32 n")
    if not 1 <= window <= MAX_WINDOW or not 3 <= max_match <= 258:
        raise ValueError(
            f"match_bitplane_batch: window {window} / max_match {max_match} "
            f"outside [1, {MAX_WINDOW}] / [3, 258]"
        )
    build.require_cuda("match_bitplane_batch", data, n)
    B, N = data.shape
    dist = torch.empty(B, N, dtype=torch.int32, device=data.device)
    length = torch.empty_like(dist)
    if B * N == 0:
        return dist, length
    code = build.library().match2_launch(
        data.data_ptr(), n.data_ptr(), dist.data_ptr(), length.data_ptr(),
        B, N, window, max_match, build.stream_handle(data.device),
    )
    build.check(code, "match2")
    match_bitplane_batch.launches += 1
    return dist, length


match_bitplane_batch.launches = 0
