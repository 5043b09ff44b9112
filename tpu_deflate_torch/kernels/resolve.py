"""Back-reference resolution by pointer doubling (plain version only).

Each output position points at its parent (itself for a literal or
stored byte, the byte it copies for a match byte); the value of a
position is the value at the root of its chain.  The TPU kernel
``tpu_deflate.kernels.resolve.resolve_roots`` serves the JAX package's
XLA expand route, which the port does not take: the expand kernel
(``kernels/expand3.py``) resolves matches as it writes them, and this
module is part of that kernel's plain version.
"""

from __future__ import annotations

import torch


def resolve_roots_plain(parent: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """val at the root of each position's parent chain; int64[..., N]
    indices into the last axis.  Doubles until no parent changes."""
    p = parent
    while True:
        nxt = torch.gather(p, -1, p)
        if torch.equal(nxt, p):
            return torch.gather(val, -1, p)
        p = nxt
