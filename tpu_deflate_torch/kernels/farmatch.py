"""The exact far matcher of the full-window encode (``csrc/farmatch.cu``).

For every position i of a lane: the 4 most recent earlier occurrences of
its 3-byte key and the most recent of its hashed 6- and 10-byte keys, each
taken where its distance lies in [1, window] and its 3 bytes equal i's,
probed to 16 bytes; the longest wins, the nearer among equal lengths, and
the winner alone extends to ``max_match``.  Lengths stop at n.  Returns
(dist, length) int32[B, N], zero where a position has no match: the
output of ``ops.encode._match_candidates_multi``, the plain version, which
CPU tensors take (``ops.encode._match_lanes`` routes them there).
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.kernels import build

MAX_WINDOW = 32768


def far_match_batch(data: torch.Tensor, n: torch.Tensor, window: int,
                    max_match: int):
    """(dist, length) int32[B, N] of data uint8[B, N], n int32[B], on the
    card: the keys, a stable sort of them, the previous occurrences, then
    the match, three kernel launches and the sort's."""
    if data.dtype != torch.uint8 or n.dtype != torch.int32:
        raise ValueError("far_match_batch: expects uint8 data, int32 n")
    if not 1 <= window <= MAX_WINDOW or not 3 <= max_match <= 258:
        raise ValueError(
            f"far_match_batch: window {window} / max_match {max_match} "
            f"outside [1, {MAX_WINDOW}] / [3, 258]")
    build.require_cuda("far_match_batch", data, n)
    B, N = data.shape
    dist = torch.empty(B, N, dtype=torch.int32, device=data.device)
    length = torch.empty_like(dist)
    if B * N == 0:
        return dist, length
    lib = build.library()
    stream = build.stream_handle(data.device)
    # the 3-byte key and the 6- and 10-byte hashes, one plane each
    keys = torch.empty(3, B, N, dtype=torch.int32, device=data.device)
    build.check(lib.farmatch_keys_launch(
        data.data_ptr(), n.data_ptr(), keys.data_ptr(), B, N, stream),
        "farmatch_keys")
    # stable: the positions of one key end adjacent, in position order
    sorted_keys, order = torch.sort(keys.view(3 * B, N), dim=1, stable=True)
    prev = keys  # every entry is written again
    build.check(lib.farmatch_prev_launch(
        sorted_keys.data_ptr(), order.data_ptr(), prev.data_ptr(), 3 * B, N,
        stream), "farmatch_prev")
    build.check(lib.farmatch_launch(
        data.data_ptr(), n.data_ptr(), prev.data_ptr(), dist.data_ptr(),
        length.data_ptr(), B, N, window, max_match, stream), "farmatch")
    far_match_batch.launches += 1
    return dist, length


far_match_batch.launches = 0
