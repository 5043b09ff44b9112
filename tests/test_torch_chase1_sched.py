"""A numpy model of the ``ent_from_phi`` kernel's schedule
(``tpu_deflate_torch/csrc/chase1.cu``): block b loads the maps of its run of
RUN tiles (all T where T is smaller), every entry of 64 or more turned to
the sink 64, and composes the run's prefix maps by doubling (S_k <- S_k o
S_{k-d}, log2(RUN) rounds); it publishes every tile's prefix map (the
identity for the run's first tile) and the run's composite, then arrives.
Blocks arrive in any order; the last to arrive carries p0 through the
composites, CHUNK at a time: group maps of GROUP composites, one walk
through the group maps, one walk a group through its composites, giving
each block's entry phase; then ent[t] = P_t[x_b], -1 outside [0, 64).

The model must equal ``ent_from_phi_plain`` on the maps of
``tests/test_torch_foreign.py`` and on the edge maps of
``tpu_deflate_torch.lanes.ent_edge_maps`` (an orbit that stops in the
first tile, one that stops in the last, entries of 64..190 and 192..255),
at T = 32, 256, 8192 and 16384 (two chunks) and p0 = 0, 5, 63, 64; and the
JAX package's ``ent_from_phi`` in interpret mode at T = 256."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_deflate.kernels.chase1 as jchase  # noqa: E402
from tests.test_torch_foreign import _maps  # noqa: E402
from tpu_deflate_torch import lanes as L  # noqa: E402
from tpu_deflate_torch.kernels.chase1 import ENT_RUN, ent_from_phi_plain  # noqa: E402

CHUNK, GROUP = 2 * ENT_RUN, 16  # csrc/chase1.cu's kChunk, kGroup
SINK = 64


def _step(m, x):
    """Phases x through map rows m (same leading shape), the sink kept."""
    return np.where(x < SINK, np.take_along_axis(m, x.clip(0, SINK - 1), -1), SINK)


def _one(m, x: int) -> int:
    """One phase through one map."""
    return int(m[x]) if x < SINK else SINK


def model_ent(phiP, p0: int, seed: int, stats):
    T = phiP.shape[2]
    run = min(ENT_RUN, T)
    nb = T // run
    w = phiP[0].astype(np.int64) & 0xFFFFFFFF
    sh = 8 * np.arange(4)
    maps = ((w[:, None, :] >> sh[None, :, None]) & 0xFF).reshape(64, T).T
    maps = np.minimum(maps, SINK)  # [T, 64]
    pre = np.full((T, 64), -7)  # scratch: written before it is read
    comp = np.full((nb, 64), -7)
    arrived = []
    for b in np.random.default_rng(seed).permutation(nb):  # any order
        S = maps[b * run : (b + 1) * run]
        d, rounds = 1, 0
        while d < run:
            S = np.concatenate([S[:d], _step(S[d:], S[:-d])])
            d, rounds = 2 * d, rounds + 1
        stats["rounds"] = rounds
        pre[b * run] = np.arange(64)
        pre[b * run + 1 : (b + 1) * run] = S[:-1]
        comp[b] = S[-1]
        arrived.append(b)
    assert len(arrived) == nb and (pre >= 0).all() and (comp >= 0).all()

    # the last block to arrive
    x = p0 if 0 <= p0 < SINK else SINK
    carry = np.empty(nb, np.int64)
    stats["chunks"] = 0
    for c0 in range(0, nb, CHUNK):
        n = min(CHUNK, nb - c0)
        groups = -(-n // GROUP)
        gmap = np.empty((groups, 64), np.int64)
        for g in range(groups):
            y = np.arange(64)
            for j in range(g * GROUP, min(n, (g + 1) * GROUP)):
                y = _step(comp[c0 + j], y)
            gmap[g] = y
        gent = []
        for g in range(groups):
            gent.append(x)
            x = _one(gmap[g], x)
        for g in range(groups):
            y = gent[g]
            for j in range(g * GROUP, min(n, (g + 1) * GROUP)):
                carry[c0 + j] = y
                y = _one(comp[c0 + j], y)
        stats["chunks"] += 1
    xb = carry[np.arange(T) // run]
    v = np.where(xb < SINK, pre[np.arange(T), xb.clip(0, 63)], SINK)
    return np.where(v < SINK, v, -1).astype(np.int32)[None, None]


def _check(phiP, p0, T):
    stats = {}
    got = model_ent(phiP, p0, T + p0, stats)
    plain = ent_from_phi_plain(torch.from_numpy(phiP),
                               torch.tensor(p0, dtype=torch.int32))
    np.testing.assert_array_equal(got, plain.numpy())
    assert stats["rounds"] == min(ENT_RUN, T).bit_length() - 1
    assert stats["chunks"] == -(-(T // min(ENT_RUN, T)) // CHUNK)
    return got


@pytest.mark.parametrize("T,p0", [(256, 0), (256, 5), (8192, 0), (8192, 5)])
def test_model_equals_plain_and_pallas_foreign_maps(T, p0):
    phiP = _maps(T, T + p0)
    got = _check(phiP, p0, T)
    ent = got[0, 0]
    assert ent[0] == p0 and (ent >= 0).sum() > 1
    if T == 256:
        want = jchase.ent_from_phi(jnp.asarray(phiP), jnp.int32(p0), interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("kind", ["random", "stops_first", "stops_last", "high"])
@pytest.mark.parametrize("T", [32, 256, 8192, 16384])
def test_model_equals_plain_edges(T, kind):
    phiP = L.ent_edge_maps(T, kind, T)
    for p0 in (0, 5, 63, 64):
        ent = _check(phiP, p0, T)[0, 0]
        if p0 == 64:
            assert (ent == -1).all()
            continue
        assert ent[0] == p0
        if kind == "stops_first":
            assert (ent[1:] == -1).all()
        elif kind in ("random", "stops_last"):
            assert (ent >= 0).all()  # the orbit reaches the last tile
        if T == 256:
            want = jchase.ent_from_phi(jnp.asarray(phiP), jnp.int32(p0),
                                       interpret=True)
            np.testing.assert_array_equal(ent, np.asarray(want)[0, 0])
