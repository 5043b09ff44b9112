"""A numpy model of the schedule of ``resolve_roots``
(``tpu_deflate_torch/csrc/resolve.cu``), in two launches.

Launch 1: a block takes a tile of TILE positions of a row, keeps each
parent inside the tile as a pointer and one outside it as an exit, and
jumps pointers in place until a round moves nothing; threads of a round
see some of that round's earlier writes and not others.  Each position's
entry (its root in the tile, or its exit) goes to the pointer table, and
a position whose root lies in the tile gets its value.  Launch 2: every
position whose entry lies outside its tile chases the table until it
reaches a position that is its own entry, writing each position it
reaches over its own entry; chases step in random interleavings, and a
read of an entry that has been rewritten sees the old or the new value.

The model runs with a small tile and must equal ``resolve_roots_plain``
and the JAX package's ``_resolve_xla`` on ``_forest``'s cases of
``tests/test_torch_decode_stream.py``, on
``tpu_deflate_torch.lanes.resolve_edge_forests`` (parents after their
positions, a chain that zigzags across every tile, three rows of no tile
multiple, rows of one position) and on the parents that ``expand_batch``
builds from a stored-mix stream; every output is written once, a tile
stops within log2(TILE) + 1 rounds, and no chase outlasts the row."""

from __future__ import annotations

import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_deflate.kernels.resolve as jres  # noqa: E402
import tpu_deflate_torch as td  # noqa: E402
from tests.test_torch_decode_stream import _bench, _forest  # noqa: E402
from tpu_deflate_torch import lanes as L  # noqa: E402
from tpu_deflate_torch.kernels.resolve import resolve_roots_plain  # noqa: E402
from tpu_deflate_torch.ops import expand as X  # noqa: E402

TILE = 64  # the model's tile; the kernel's is tpu_deflate_torch.kernels.resolve.TILE


def model_resolve(parent, val, tile: int, seed: int, stats):
    """The two launches on parent, val int[B, N]: returns int64[B, N]."""
    B, N = parent.shape
    rng = np.random.default_rng(seed)
    pos = np.arange(B * N)
    row0 = pos // N * N
    tile_of = row0 + (pos - row0) // tile * tile  # first position of p's tile
    q = row0 + np.clip(parent.reshape(-1).astype(np.int64), 0, N - 1)
    v = val.reshape(-1).astype(np.int64)
    out = np.zeros(B * N, np.int64)
    writes = np.zeros(B * N, np.int64)

    # launch 1: every tile at once (no block reads another's pointers);
    # an exit is -1 - its position
    inside = (q >= tile_of) & (q < np.minimum(tile_of + tile, row0 + N))
    ref = np.where(inside, q, -1 - q)
    rounds = 0
    while True:
        rounds += 1
        moved = False
        order = rng.permutation(B * N)
        for g in np.array_split(order, int(rng.integers(1, 6))):
            r = ref[g]
            live = r >= 0
            r2 = np.where(live, ref[np.where(live, r, 0)], r)
            mv = live & (r2 != r)
            ref[g[mv]] = r2[mv]
            moved |= bool(mv.any())
        if not moved:
            break
    assert rounds <= tile.bit_length()  # log2(tile) + 1
    stats["rounds"] = max(stats["rounds"], rounds)
    root_here = ref >= 0
    ptr = np.where(root_here, ref, -1 - ref)
    out[root_here] = v[ref[root_here]]
    writes[root_here] += 1

    # launch 2: the chases, a random subset a step, each read old or new
    old = ptr.copy()
    x = ptr.copy()
    active = tile_of[ptr] != tile_of
    steps = np.zeros(B * N, np.int64)
    while active.any():
        idx = np.nonzero(active)[0]
        go = idx[rng.random(len(idx)) < rng.uniform(0.2, 1.0)]
        if len(go) == 0:
            go = idx[:1]
        xs = x[go]
        y = np.where(rng.random(len(go)) < 0.5, old[xs], ptr[xs])
        done = y == xs
        out[go[done]] = v[y[done]]
        writes[go[done]] += 1
        active[go[done]] = False
        ptr[go[~done]] = y[~done]
        x[go[~done]] = y[~done]
        steps[go] += 1
    assert steps.max(initial=0) <= N
    stats["steps"] = max(stats["steps"], int(steps.max(initial=0)))
    assert (writes == 1).all()
    return out.reshape(B, N)


def _check(parent, val, seed: int):
    """The model against plain and JAX in three interleavings; returns
    its stats."""
    want = resolve_roots_plain(torch.from_numpy(parent).long(),
                               torch.from_numpy(val)).numpy()
    jwant = np.asarray(jres._resolve_xla(jnp.asarray(parent), jnp.asarray(val)))
    np.testing.assert_array_equal(want, jwant)
    stats = {"rounds": 0, "steps": 0}
    for s in range(3):
        got = model_resolve(parent, val, TILE, seed + s, stats)
        np.testing.assert_array_equal(got, want)
    return stats


@pytest.mark.parametrize("case", ["near", "far", "d1_run"])
def test_model_equals_plain_and_jax_forests(case):
    parent, val = _forest(case)
    stats = _check(parent, val, len(case))
    if case == "d1_run":  # the chain crosses every tile
        assert stats["rounds"] >= 3 and stats["steps"] >= 1


EDGES = L.resolve_edge_forests(TILE, 11)


@pytest.mark.parametrize("name", list(EDGES))
def test_model_equals_plain_and_jax_edges(name):
    parent, val = EDGES[name]
    stats = _check(parent, val, 7 + len(name))
    at = np.arange(parent.shape[1])
    if name in ("forward", "zigzag"):
        assert (parent > at).any() and stats["steps"] >= 2
    if name == "rows_b3":
        assert parent.shape[0] == 3 and parent.shape[1] % TILE
    if name == "n1":
        assert parent.shape[1] == 1 and stats["steps"] == 0


def test_model_equals_plain_and_jax_stored_mix():
    """The parents and values that ``expand_batch`` hands resolve_roots
    for a zlib -6 stream of text, random bytes and text (its stored
    blocks send the row to the resolve route)."""
    rng = np.random.default_rng(5)
    mixed = _bench(40000) + rng.integers(0, 256, 60000, np.uint8).tobytes() \
        + _bench(40000, 1 << 20)
    calls = []
    orig = X.resolve_roots

    def spy(parent, val):
        calls.append((parent.numpy().copy(), val.numpy().copy()))
        return orig(parent, val)

    X.resolve_roots = spy
    try:
        assert td.decompress(zlib.compress(mixed, 6), device="cpu") == mixed
    finally:
        X.resolve_roots = orig
    assert len(calls) == 1
    parent, val = calls[0]
    assert parent.shape[1] >= 1 << 17
    _check(parent, val, 3)
