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
JAX package's ``ent_from_phi`` in interpret mode at T = 256.

Below it, a model of ``visited_from_adv``'s kernel (runs of VISIT_RUN
tiles a block, tile-parallel, maps published and read back,
``model_visit``), held to ``visited_from_adv_plain`` and the
JAX kernel in interpret mode on the five chases of
``tests/test_torch_foreign.py`` and the edges of
``tpu_deflate_torch.lanes.visit_edge_cases`` (p0 = 63, a terminator at p0,
an orbit to the last position, T = 256, jumps of 1..64)."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_deflate.kernels.chase1 as jchase  # noqa: E402
from tests.test_torch_foreign import _chase_case, _maps  # noqa: E402
from tpu_deflate_torch import lanes as L  # noqa: E402
from tpu_deflate_torch.kernels.chase1 import (  # noqa: E402
    ENT_RUN,
    VISIT_RUN,
    ent_from_phi_plain,
    visited_from_adv_plain,
)

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


# ---------------------------------------------------------------------------
# visited_from_adv: one block, tile-parallel (csrc/chase1.cu, visit_kernel)
# ---------------------------------------------------------------------------

MAP_BYTES = 68  # a run's map: 65 entries (the phases and the sink), 17 words


def model_visit(advT, termT, p0: int, seed: int, stats):
    """Blocks take runs of VISIT_RUN tiles by ticket and run interleaved in
    random orders.  A block loads its columns into a tile a row (q + adv,
    255 at a terminator; a jump outside 1..64 traps), doubles a copy in
    place, a tile's words in a random order (a read sees the word before
    or after its rewrite), while any entry is inside its tile; walks each
    phase and the sink through its tiles (the start's tile takes the
    start's phase), keeping each tile's entry; publishes its map, every
    byte with bit 7 set; polls the maps of the runs before it until every
    byte of every word has bit 7 (the words hold garbage before); carries
    the sink through them; walks each tile from its entry, marking; writes
    its columns."""
    T = advT.shape[1]
    P = 64 * T
    run = min(VISIT_RUN, T)
    nb = T // run
    rng = np.random.default_rng(seed)
    if ((advT < 1) | (advT > 64))[termT == 0].any():
        raise RuntimeError("trap")
    t0 = p0 // 64 if 0 <= p0 < P else -1
    e0 = p0 & 63
    # scratch: unpublished words hold garbage with some byte under 0x80
    maps_g = rng.integers(0, 256, (nb, MAP_BYTES))
    maps_g[:, 0] &= 0x7F
    vis = np.full((64, T), -1, np.int32)

    def exit_phase(exits, x):
        if x >= 64:
            return 64
        j = int(exits[x])
        return j - 64 if j < 128 else 64

    def block(b):
        tb = b * run
        cols = slice(tb, tb + run)
        nxt = np.where(termT[:, cols] != 0, 255,
                       np.arange(64)[:, None] + advT[:, cols]).T.copy()  # [run, 64]
        jmp = nxt.copy()
        yield
        for k in range(run):  # a warp's two tiles order their own rounds
            for r in range(6):
                inside = False
                for w in rng.permutation(16):
                    for h in range(4):
                        e = jmp[k, 4 * w + h]
                        if e < 64:
                            jmp[k, 4 * w + h] = jmp[k, e]
                            inside |= bool(jmp[k, e] < 64)
                stats["rounds"] = max(stats.get("rounds", 0), r + 1)
                if not inside:
                    break
        assert (jmp >= 64).all()
        pre = np.empty((run, 65), np.int64)
        own = np.zeros(MAP_BYTES, np.int64)
        for e in range(65):
            y = e
            for k in range(run):
                if tb + k == t0:
                    y = e0
                pre[k, e] = y
                y = exit_phase(jmp[k], y)
            own[e] = y
        maps_g[b] = own | 0x80
        yield
        got = []
        for j in range(b):  # the block's threads poll the words at once
            while (maps_g[j] < 0x80).any():
                stats["waits"] = stats.get("waits", 0) + 1
                yield
            got.append(maps_g[j] & 0x7F)
        x = 64
        for m in got:
            x = int(m[x])
        yield
        for k in range(run):
            col = np.zeros(64, np.int32)
            y = int(pre[k, x])
            steps = 0
            while y < 64:
                col[y] = 1
                steps += 1
                y = 64 if nxt[k, y] == 255 else int(nxt[k, y])
            stats["walk"] = max(stats.get("walk", 0), steps)
            vis[:, tb + k] = col

    running, ticket, steps = [], 0, 0
    cap = int(rng.integers(1, nb + 1))  # blocks resident at once
    while ticket < nb or running:
        steps += 1
        assert steps < 10**6, "the blocks deadlocked"
        if ticket < nb and len(running) < cap and (not running or rng.random() < 0.4):
            running.append(block(ticket))
            ticket += 1
            continue
        g = running[int(rng.integers(len(running)))]
        try:
            next(g)
        except StopIteration:
            running.remove(g)
    assert (vis >= 0).all()
    return vis


def _check_visit(advT, termT, p0):
    stats = {}
    got = model_visit(advT, termT, p0, int(advT.sum()) + p0, stats)
    plain = visited_from_adv_plain(torch.from_numpy(advT), torch.from_numpy(termT),
                                   torch.tensor(p0, dtype=torch.int32))
    np.testing.assert_array_equal(got, plain.numpy())
    want = jchase.visited_from_adv(jnp.asarray(advT), jnp.asarray(termT),
                                   jnp.int32(p0), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["rounds"] <= 6 and stats["walk"] <= 64
    return got


@pytest.mark.parametrize("name", ["random0", "random1", "random2", "p0_5_random3",
                                  "zlib9_header"])
def test_visit_model_equals_plain_and_pallas(name):
    adv, term, p0 = _chase_case(name)
    T = len(adv) // 64
    advT = adv.reshape(T, 64).T.astype(np.int32).copy()
    termT = term.reshape(T, 64).T.astype(np.int32).copy()
    got = _check_visit(advT, termT, p0)
    assert got.sum() > 1


@pytest.mark.parametrize("name", list(L.visit_edge_cases(0)))
def test_visit_model_equals_plain_edges(name):
    advT, termT, p0 = L.visit_edge_cases(11)[name]
    got = _check_visit(advT, termT, p0)
    flat = got.T.reshape(-1)
    assert flat[p0] == 1 and not flat[:p0].any()
    if name == "term_at_p0":
        assert flat.sum() == 1
    if name == "to_last":
        assert flat[-1] == 1
    if name == "T256":
        assert got.shape == (64, 256)


def test_visit_model_traps_outside_its_domain():
    advT, termT, p0 = L.visit_edge_cases(11)["jumps_to_64"]
    advT = advT.copy()
    termT = termT.copy()
    advT[3, 7], termT[3, 7] = 65, 0
    with pytest.raises(RuntimeError, match="trap"):
        model_visit(advT, termT, p0, 0, {})
