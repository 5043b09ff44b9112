"""Back-reference resolution (``csrc/resolve.cu``).

Each output position points at its parent (itself for a literal or
stored byte, the byte it copies for a match byte); the value of a
position is the value at the root of its chain.  ``ops.expand.
expand_batch`` takes this route for rows that the expand kernels do not:
a long row with a stored token, or a row whose length is no multiple of
2048, as the JAX package's ``expand_batch`` sends them through
``tpu_deflate.kernels.resolve.resolve_roots``.  The plain version is also
the second half of the expand kernels' plain versions.
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.kernels import build

TILE = 4096  # csrc/resolve.cu's kTile: positions a block resolves in shared memory


def resolve_roots_plain(parent: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """val at the root of each position's parent chain; int64[..., N]
    indices into the last axis.  Doubles until no parent changes."""
    p = parent
    while True:
        nxt = torch.gather(p, -1, p)
        if torch.equal(nxt, p):
            return torch.gather(val, -1, p)
        p = nxt


def resolve_roots(parent: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """val at the root of each position's parent chain: parent, val
    int32[..., N], parents in [0, N) and every chain ending at a position
    that is its own parent; returns int32[..., N].

    CPU tensors take the plain version; CUDA tensors launch the kernel:
    tiles resolved in shared memory, then chains chased across tiles, two
    launches a call."""
    if parent.shape != val.shape:
        raise ValueError(f"resolve_roots: parent {tuple(parent.shape)} and "
                         f"val {tuple(val.shape)} differ in shape")
    if parent.dtype != torch.int32 or val.dtype != torch.int32:
        raise ValueError("resolve_roots: expects int32 parent and val")
    if parent.device.type == "cpu":
        return resolve_roots_plain(parent.long(), val)
    build.require_cuda("resolve_roots", parent, val)
    N = parent.shape[-1]
    out = torch.empty_like(val)
    if parent.numel() == 0:
        return out
    ptr = torch.empty_like(parent)  # the pointer table, all written
    code = build.library().resolve_launch(
        parent.data_ptr(), val.data_ptr(), ptr.data_ptr(), out.data_ptr(),
        parent.numel() // N, N, build.stream_handle(parent.device),
    )
    build.check(code, "resolve")
    resolve_roots.launches += 1
    return out


resolve_roots.launches = 0
