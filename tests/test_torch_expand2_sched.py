"""A numpy model of the ``expand_fused2`` kernel's schedule
(``tpu_deflate_torch/csrc/expand2.cu``): a block takes a ticket (tile-major:
tile j of lane b is ticket j * B + b) when it starts; it finds the owners
of its tile's first and last live bytes, scatters the start of every token
inside the tile and max-scans them into an owner a byte; a literal byte is
a root with its value, byte p of a match at offset o with distance d > 0
points at o - d + ((p - o) mod d), or at byte 0 where that lies before the
row, kept as a local index inside the tile and as a row position
("external") before it; pointer jumping in rounds until nothing moves.
Then it publishes each live byte's entry in the lane's chain table (its
value, or the external position) and raises its flag, waits for the flags
of the lane's tiles up to the highest its external bytes name, chases each
external byte through the published entries to a value, writes the value
back over the byte's own entry, and writes its tile.

Blocks run interleaved at random, a few resident at a time, a chase
yielding after every step so that other blocks' write-backs land between
its reads; the model fails on a deadlock, on a wait for a tile of a
higher ticket, and on a read of an entry of a tile that has not
published (the table and the row start as garbage).  It must equal
``expand_fused2_plain``, and the JAX package's ``expand_fused2`` in
interpret mode on the cases of ``tests/test_torch_decode_stream.py``, at
tiles of 2048 bytes (four a row); and the plain version on the edge lanes
of ``tpu_deflate_torch.lanes.expand2_edge_lanes`` at tiles of 1024 bytes
and at the kernel's own (``TILE``)."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_deflate.kernels.expand2 as jexp2  # noqa: E402
from tests.test_torch_decode_stream import E2_CAP, E2_K, EXPAND2_CASES, _layout  # noqa: E402
from tpu_deflate_torch import lanes as L  # noqa: E402
from tpu_deflate_torch.kernels.expand2 import TILE, expand_fused2_plain  # noqa: E402
from tpu_deflate_torch.ops import expand as X  # noqa: E402


def _tile_parents(off, c1, tb, tp, total, out_cap, tile, lane, j, stats):
    """A block's in-tile work: (ref, val) of its tile, ref a local index
    (>= 0) or -(row position + 1) after the jumping."""
    K = off.shape[1]
    t0 = j * tile
    width = min(tile, out_cap - t0)
    ntok = min(max(int(tp[lane]), 0), K)
    tot = min(max(int(total[lane]), 0), out_cap)
    live = max(0, min(width, tot - t0))
    offl = off[lane, :ntok].astype(np.int64)
    first = last = -1
    if live > 0 and ntok > 0:
        first = int(np.searchsorted(offl, t0, "right")) - 1
        last = int(np.searchsorted(offl, t0 + live - 1, "right")) - 1
    own = np.full(tile, -1, np.int64)
    own[0] = first
    starts = np.arange(first + 1, last + 1)
    ks = offl[starts] - t0
    keep = (ks > 0) & (ks < live)
    np.maximum.at(own, ks[keep], starts[keep])
    own = np.maximum.accumulate(own)

    k = np.arange(tile)
    p = t0 + k
    m = own.clip(0)
    c = c1[lane, m].astype(np.int64)
    kind = (c >> 9) & 3
    d = tb[lane, m].astype(np.int64)
    o = off[lane, m].astype(np.int64)
    valid = (k < live) & (own >= 0)
    val = np.where(valid & (kind == 0), c & 0xFF, 0)
    match = valid & (kind == 1) & (d > 0) & (o <= p)
    s = np.maximum(o - d + (p - o) % np.maximum(d, 1), 0)
    ref = np.where(match, np.where(s >= t0, s - t0, -(s + 1)), k)
    rounds = 0
    while True:
        nxt = np.where(ref >= 0, ref[ref.clip(0)], ref)
        rounds += 1
        if (nxt == ref).all():
            break
        ref = nxt
    stats["rounds"] = max(stats.get("rounds", 0), rounds)
    return ref, val, width


def model_expand2(off, c1, tb, tp, total, out_cap, tile, resident, seed,
                  stats):
    """The kernel on every lane under a random interleaving of its blocks:
    uint8[B, out_cap]."""
    B = off.shape[0]
    ntiles = -(-out_cap // tile)
    out = np.full((B, out_cap), 0xAB, np.uint8)  # garbage, as torch.empty
    table = np.full((B, out_cap), 1 << 30, np.int64)  # garbage too
    flags = np.zeros((B, ntiles), bool)
    rng = np.random.default_rng(seed)

    def block(ticket):
        lane, j = ticket % B, ticket // B
        t0 = j * tile
        ref, val, width = _tile_parents(off, c1, tb, tp, total, out_cap, tile,
                                        lane, j, stats)
        e = np.where(ref >= 0, -1 - val[ref.clip(0)], -ref - 1)
        live = int(np.count_nonzero(np.arange(tile) < width))
        table[lane, t0 : t0 + live] = e[:live]  # garbage past total: unread
        flags[lane, j] = True
        chased = e >= 0
        if chased.any():
            hi = int(e[chased].max()) // tile
            assert all(jj * B + lane < ticket for jj in range(hi + 1))
            waited = False
            while not flags[lane, : hi + 1].all():
                waited = True
                yield "wait"
            stats["waits"] = stats.get("waits", 0) + waited
            stats["external"] = stats.get("external", 0) + int(chased.sum())
        hops = 0
        while (e >= 0).any():
            at = e >= 0
            assert flags[lane, e[at] // tile].all()
            e[at] = table[lane, e[at]]
            hops += 1
            yield "step"
        stats["hops"] = max(stats.get("hops", 0), hops)
        table[lane, t0 + np.flatnonzero(chased)] = e[chased]
        out[lane, t0 : t0 + width] = (-1 - e[:width]).astype(np.uint8)

    tickets, active = 0, []
    while tickets < B * ntiles or active:
        while len(active) < resident and tickets < B * ntiles:
            active.append(block(tickets))  # the ticket is taken at start
            tickets += 1
        moved, done = False, []
        for i in rng.permutation(len(active)):
            try:
                moved |= next(active[i]) != "wait"
            except StopIteration:
                moved = True
                done.append(i)
        assert moved, "every resident block waits: deadlock"
        active = [a for i, a in enumerate(active) if i not in done]
    assert flags.all()
    return out


def _check(off, c1, tb, tp, total, out_cap, tile, resident=3, seed=0):
    stats = {}
    got = model_expand2(off, c1, tb, tp, total, out_cap, tile, resident, seed,
                        stats)
    plain = expand_fused2_plain(*(torch.from_numpy(np.ascontiguousarray(x))
                                  for x in (off, c1, tb, tp, total)), out_cap)
    np.testing.assert_array_equal(got, plain.numpy())
    return got, stats


@pytest.mark.parametrize("name", list(EXPAND2_CASES))
def test_model_equals_plain_and_pallas(name):
    tks, tas, tbs = EXPAND2_CASES[name]
    _, _, tb, off, c1, tp, total = _layout(tks, tas, tbs, E2_K)
    got, stats = _check(off, c1, tb, tp, total, E2_CAP, tile=2048)
    want = jexp2.expand_fused2(
        *(jnp.asarray(x) for x in (off, c1, tb, tp, total)), out_cap=E2_CAP,
        max_dist=32768 if name == "wide_window" else 2048, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.uint8))
    if name in ("d1_run_crossing", "d2_run_crossing", "wide_window"):
        assert stats["external"] >= 1  # a tile copied from one before it


@pytest.mark.parametrize("tile", [1024, TILE])
def test_model_equals_plain_edges(tile):
    names, tk, ta, tb, tp, cut, out_cap = L.expand2_edge_lanes(9, tile)
    assert out_cap % tile and (cut[cut >= 0] % tile).all()
    off, c1, total = (x.numpy() for x in X._expand_inputs(
        torch.from_numpy(tk), torch.from_numpy(ta), torch.from_numpy(tp)))
    total = np.where(cut >= 0, cut, total).astype(np.int32)
    got, stats = _check(off, c1, tb, tp, total, out_cap, tile, resident=4,
                        seed=tile)
    lane = dict(zip(names, got))
    assert not lane["tp_0"].any()
    assert not lane["total_cut"][2 * tile + 77 :].any()
    assert lane["d1_run"][: int(total[names.index("d1_run")])].tolist() == [65] * (
        int(total[names.index("d1_run")]))
    row = lane["tile_all_earlier"]  # tile 1 copies tile 0, byte for byte
    np.testing.assert_array_equal(row[tile : 2 * tile], row[:tile])
    far = lane["far_32768"]
    at = 32768 + 10
    np.testing.assert_array_equal(far[at : at + 100], far[10:110])
    assert (far[at + 100 : at + 120] == far[0]).all()  # before the row: byte 0
    dz = lane["distance_0"]
    assert not dz[500:550].any() and not dz[560:610].any()  # 60 back: zeros
    assert stats["external"] >= tile
