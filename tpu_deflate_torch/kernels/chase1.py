"""Single-lane boundary chase over 64-bit tiles (``csrc/chase1.cu``).

The device-paced decode of one stream (``ops.foreign``) needs two chases
for one lane, each over positions laid out as (row = in-tile position q,
column = tile t), position p = 64 t + q:

  ent_from_phi      the entry phase of one orbit in every tile, from the
                    per-tile transfer maps that ``kernels.tokenize_dyn.
                    tokenize_dyn_hier`` builds (entry e of tile t is the
                    phase at which an orbit entering t at e enters t + 1,
                    STOP = 191 where it ends); feeds the tokenizer's walk.
  visited_from_adv  every position on the orbit of p0 under next = p +
                    adv[p], which stops at a terminator (the terminator is
                    on it); the code-length region of a dynamic header.

The counterparts of ``tpu_deflate.kernels.chase1``; CPU tensors take the
plain versions, CUDA tensors launch the kernels.
"""

from __future__ import annotations

import math

import torch

from tpu_deflate_torch.kernels import build

TILE = 64
STOP = 191  # a transfer-map entry whose orbit ended in the tile
ENT_RUN = 64  # csrc/chase1.cu's kRun: tiles one block of ent_from_phi composes
VISIT_RUN = 8  # csrc/chase1.cu's kVisitRun: tiles a block of visited_from_adv takes


def _check_p0(name: str, p0: torch.Tensor, device) -> None:
    if p0.dtype != torch.int32 or p0.numel() != 1 or p0.device != device:
        raise ValueError(f"{name}: p0 must be one int32 on {device}")


def _unpack_maps(phiP: torch.Tensor) -> torch.Tensor:
    """Packed maps int32[1, 16, T] (entries 4g..4g+3 of a tile in the
    bytes of row g, little-endian) -> int64[64, T]."""
    w = phiP[0].to(torch.int64) & 0xFFFFFFFF
    sh = 8 * torch.arange(4, device=phiP.device)
    return ((w[:, None, :] >> sh[None, :, None]) & 0xFF).reshape(TILE, -1)


def ent_from_phi_plain(phiP: torch.Tensor, p0: torch.Tensor) -> torch.Tensor:
    """Plain version: ent[t] = the phase after composing the maps of tiles
    0..t-1 on p0, by doubling over prefixes of tiles; a phase outside
    [0, 64) has left the orbit (-1)."""
    phi = _unpack_maps(phiP).T  # [T, 64]
    T = phi.shape[0]
    # maps with a sink 64 for every phase outside [0, 64)
    f = torch.cat([phi.clamp(max=TILE),
                   torch.full((T, 1), TILE, dtype=torch.int64, device=phi.device)], 1)
    # pre[t] = the maps of tiles 0..t-1 composed; identity at t = 0
    ident = torch.arange(TILE + 1, device=phi.device)
    pre = torch.cat([ident[None], f[:-1]], 0)
    k = 1
    while k < T:
        # pre[t] <- pre[t] o pre[t - k]
        pre = torch.cat([pre[:k], torch.gather(pre[k:], 1, pre[:-k])], 0)
        k *= 2
    x = p0.reshape(1).to(torch.int64)
    ent = pre.index_select(1, torch.where((x >= 0) & (x < TILE), x, TILE))[:, 0]
    return torch.where(ent < TILE, ent, -1).to(torch.int32)[None, None]


def ent_from_phi(phiP: torch.Tensor, p0: torch.Tensor) -> torch.Tensor:
    """Entry phase int32[1, 1, T] of the orbit that enters tile 0 at p0
    (int32[], < 64) in each tile, -1 after it ended; phiP int32[1, 16, T]
    packed maps, T a power of two."""
    if phiP.dtype != torch.int32 or phiP.dim() != 3 or phiP.shape[:2] != (1, 16):
        raise ValueError(f"ent_from_phi: phiP {phiP.dtype} {tuple(phiP.shape)}, "
                         "expected int32[1, 16, T]")
    T = phiP.shape[2]
    if T < 32 or T & (T - 1):
        raise ValueError(f"ent_from_phi: T = {T} is not a power of two >= 32")
    _check_p0("ent_from_phi", p0, phiP.device)
    if phiP.device.type == "cpu":
        return ent_from_phi_plain(phiP, p0)
    build.require_cuda("ent_from_phi", phiP, p0)
    ent = torch.empty(1, 1, T, dtype=torch.int32, device=phiP.device)
    # an arrival counter, each block's composite and every tile's prefix
    # map, 16 words a map (csrc/chase1.cu, ENT_RUN tiles a block)
    scratch = torch.empty(4 + 16 * (T // min(T, ENT_RUN) + T),
                          dtype=torch.int32, device=phiP.device)
    code = build.library().ent_from_phi_launch(
        phiP.data_ptr(), p0.data_ptr(), ent.data_ptr(), scratch.data_ptr(),
        scratch.numel(), T, build.stream_handle(phiP.device))
    build.check(code, "ent_from_phi")
    ent_from_phi.launches += 1
    return ent


ent_from_phi.launches = 0


def visited_from_adv_plain(advT: torch.Tensor, termT: torch.Tensor,
                           p0: torch.Tensor) -> torch.Tensor:
    """Plain version: the orbit of p0 by pointer doubling over the
    flattened positions, with a sink P for terminators and jumps past the
    end; each round marks jump[p] wherever p is marked, then doubles."""
    T = advT.shape[1]
    P = TILE * T
    dev = advT.device
    adv = advT.T.reshape(-1).to(torch.int64)
    term = termT.T.reshape(-1) != 0
    idx = torch.arange(P, device=dev)
    jump = torch.cat([torch.where(term, P, (idx + adv).clamp(0, P)),
                      torch.full((1,), P, device=dev)])
    mark = (torch.arange(P + 1, device=dev) == p0.reshape(1)).to(torch.int32)
    for _ in range(math.ceil(math.log2(P + 1)) + 1):
        mark = mark.scatter_reduce(0, jump, mark, "amax")
        jump = jump[jump]
    return mark[:P].reshape(T, TILE).T.contiguous()


def visited_from_adv(advT: torch.Tensor, termT: torch.Tensor,
                     p0: torch.Tensor) -> torch.Tensor:
    """Visited mask int32[64, T] (1 on the orbit of position p0 < 64) from
    jump lengths advT and terminators termT (nonzero), int32[64, T] in the
    (row = in-tile position, column = tile) layout; T a power of two, 64 T
    <= 16384.  Every jump that is not a terminator's is 1..64, so that it
    lands in its tile or the next, as in the JAX kernel (a header's
    code-length symbols are at most 14 bits); the kernel traps on any
    other."""
    for name, x in (("advT", advT), ("termT", termT)):
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != TILE:
            raise ValueError(f"visited_from_adv: {name} {x.dtype} "
                             f"{tuple(x.shape)}, expected int32[64, T]")
    T = advT.shape[1]
    if termT.shape != advT.shape or T & (T - 1) or TILE * T > 16384:
        raise ValueError(f"visited_from_adv: shapes {tuple(advT.shape)}, "
                         f"{tuple(termT.shape)}")
    _check_p0("visited_from_adv", p0, advT.device)
    if advT.device.type == "cpu":
        return visited_from_adv_plain(advT, termT, p0)
    build.require_cuda("visited_from_adv", advT, termT, p0)
    vis = torch.empty_like(advT)
    # a ticket counter and a 17-word map a run of VISIT_RUN tiles
    # (csrc/chase1.cu)
    scratch = torch.empty(1 + 17 * (T // min(T, VISIT_RUN)), dtype=torch.int32,
                          device=advT.device)
    code = build.library().visited_from_adv_launch(
        advT.data_ptr(), termT.data_ptr(), p0.data_ptr(), vis.data_ptr(),
        scratch.data_ptr(), scratch.numel(), T, build.stream_handle(advT.device))
    build.check(code, "visited_from_adv")
    visited_from_adv.launches += 1
    return vis


visited_from_adv.launches = 0
