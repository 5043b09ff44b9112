"""Adler-32 on the device, in int64.

Closed form of the running pair over data[:n]:

  a(n) = 1 + sum(d)                (mod 65521)
  b(n) = n + sum((n - i) * d[i])   (mod 65521)

The weighted sum of one 64 KiB chunk stays below 2^41, so int64 needs no
segmenting; the chunk states fold into the stream's checksum with the
combine rule.
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.spec.checksum import ADLER_MOD


def adler32_pair_combine(p1, p2):
    """Combine (a, b, len) states of two concatenated streams.

    Elementwise on int64 tensors (or Python ints); every intermediate is
    below 2^32, so int64 cannot overflow."""
    a1, b1, l1 = p1
    a2, b2, l2 = p2
    rem = l2 % ADLER_MOD
    a = (a1 + a2 - 1) % ADLER_MOD
    b = (b1 + b2 + rem * ((a1 - 1) % ADLER_MOD)) % ADLER_MOD
    return a, b, l1 + l2


def adler32_state(data: torch.Tensor, n: torch.Tensor):
    """(a, b) int64[B] Adler states of data[b, :n[b]]; data uint8[B, N]."""
    N = data.shape[-1]
    n = n.to(torch.int64)
    i = torch.arange(N, device=data.device, dtype=torch.int64)
    w = (n[:, None] - i).clamp_min(0)  # 0 past n masks the tail
    d = data.to(torch.int64)
    a = (1 + (d * (w > 0)).sum(-1)) % ADLER_MOD
    b = (n + (w * d).sum(-1)) % ADLER_MOD
    return a, b


def adler32_fold_states(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor):
    """(a, b, len) 0-dim int64 tensors: the states of the lanes folded in
    order, on their device, by a pairwise tree of combines (the combine is
    associative, so this is the left-to-right fold).  No lane gives the
    identity state (1, 0, 0)."""
    a, b, n = a.to(torch.int64), b.to(torch.int64), n.to(torch.int64)
    one = torch.ones(1, dtype=torch.int64, device=a.device)
    if a.shape[0] == 0:
        a, b, n = one, one - 1, one - 1
    while a.shape[0] > 1:
        if a.shape[0] % 2:  # the identity state pads the odd lane
            a, b, n = (torch.cat([a, one]), torch.cat([b, one - 1]),
                       torch.cat([n, one - 1]))
        a, b, n = adler32_pair_combine(
            (a[0::2], b[0::2], n[0::2]), (a[1::2], b[1::2], n[1::2])
        )
    return a[0], b[0], n[0]


def adler32_fold(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor) -> int:
    """Adler-32 of the lanes' data concatenated in order."""
    fa, fb, _ = adler32_fold_states(a, b, n)
    return (int(fb) << 16) | int(fa)
