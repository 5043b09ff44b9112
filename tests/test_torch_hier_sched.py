"""Numpy models of the schedules of ``tokenize_dyn_hier``'s two kernels
(``tpu_deflate_torch/csrc/tokenize_hier.cu``).

K1d, the candidates and maps: a block of K1D_BITS bit positions whose
first bit lies at or past the end bit writes K_BAD fields and STOP maps
and nothing else; any other block takes each bit's candidate and
one-step map (255 at a terminator, else phase + adv), and a warp a tile
composes the maps by five rounds of doubling (lane l holds phases l and l
+ 32, and reads another lane's two by shuffles), exits and terminators
absorbing; the maps are staged as words of four phases and stored as the
block's tiles of each phase group.  The model must equal ``hier_maps_plain``, and
its plane and maps feed the K3d model below, so that the pair is held to
the JAX package on every lane here, among them
``tpu_deflate_torch.lanes.k1d_edge_lanes`` (a 1-bit code whose chains
stay in their tile, end-of-blocks at phases 0 and 63, 48-bit symbols, end
bits inside a tile and on a block boundary).

K3d, the walk: a block takes a ticket and
with it a run of RUN consecutive tiles; a run whose first tile's chunk
starts at or past the end bit walks nothing and publishes an empty count;
a live run stages its fields, walks every tile from its entry phase once
to count its tokens and output bytes, publishes the run's count (flag 1),
reads the words of the 32 runs before it (waiting where no flag is set;
the value bits of such a word are garbage) and sums back to the nearest
prefix (flag 2), publishes its own prefix, walks again to write its tokens
at their slots and check each distance against the output before it;
then every block adds its flags, end-of-block word and count and arrives,
and the last to arrive writes meta.

Blocks run interleaved in random orders, at most a random number of them
resident at once; tickets go in launch order.  The model must equal
``tokenize_dyn_hier_plain`` on the blocks of
``tests/test_torch_foreign.py``'s HIER_CASES and on the edge lanes of
``tpu_deflate_torch.lanes.hier_edge_streams`` (pw = 2^15, and at 2^16,
where the window holds two chunks), and the JAX package's
``tokenize_dyn_batch(hier=True, tier=2)`` in interpret mode on the same
blocks at 2^15 and on the chunk-boundary lane at 2^16; every token slot
below the count is written once and no slot twice."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_foreign import HIER_CASES, HIER_PW, _hier_case  # noqa: E402
from tpu_deflate.kernels.tokenize_dyn import tokenize_dyn_batch as j_tok_dyn  # noqa: E402
from tpu_deflate_torch import lanes as L  # noqa: E402
from tpu_deflate_torch.kernels.chase1 import ent_from_phi_plain  # noqa: E402
from tpu_deflate_torch.kernels.tokenize import (  # noqa: E402
    ERR_BAD_CODE,
    ERR_DIST,
    ERR_INPUT,
    ERR_OK,
    ERR_OVERFLOW,
    K_BAD,
    K_EOB,
    K_LIT,
    K_MATCH,
)
from tpu_deflate_torch.kernels.tokenize_dyn import (  # noqa: E402
    HIER_WLK,
    K1D_BITS,
    K3D_TILES,
    TAB_OUTBASE,
    _hier_maps_plain,
    hier_maps,
    hier_maps_plain,
    hier_shape,
    tokenize_dyn_hier_plain,
)

RUN = K3D_TILES
NTOK_BITS = 20  # csrc/tokenize_hier.cu's kNtokBits
LOOK = 32  # the look-back reads a warp's worth of words at once


K1_TILES = K1D_BITS // 64  # tiles a K1d block decodes and maps
STOP = 191
BAD_FIELDS = (K_BAD << 30) | (1 << 24)


def _plane(fields) -> np.ndarray:
    """The fields as K1d packs them: kind | adv | ta | dist - 1."""
    kind, adv, ta, tb = (x.numpy().astype(np.int64) for x in fields)
    return ((kind << 30) | (adv << 24) | (ta << 15)
            | np.where(kind == K_MATCH, tb - 1, 0))


def model_k1d(rows, ends, tab, pw: int):
    """K1d's blocks on one lane: (plane int64[pw], the fields unsigned,
    phiP int32[1, 16, T]).  The candidate decode is the plain one."""
    T, end = pw // 64, int(ends[0])
    fields, _ = _hier_maps_plain(rows, ends, tab, pw)
    kind, adv = (x.numpy().astype(np.int64) for x in fields[:2])
    packed = _plane(fields)
    plane = np.full(pw, BAD_FIELDS, np.int64)
    words = np.full((16, T), STOP * 0x01010101, np.int64)
    for blk in range(pw // (64 * K1_TILES)):
        lo, hi = 64 * K1_TILES * blk, 64 * K1_TILES * (blk + 1)
        if lo >= end:  # a dead block: the constants above
            continue
        plane[lo:hi] = packed[lo:hi]
        term = (kind[lo:hi] == K_EOB) | (kind[lo:hi] == K_BAD)
        m0 = np.where(term, 255, np.arange(hi - lo) % 64 + adv[lo:hi])
        a, b = m0.reshape(K1_TILES, 64)[:, :32], m0.reshape(K1_TILES, 64)[:, 32:]
        for _ in range(5):  # lanes read this round's a and b of lane x & 31
            def pick(x):
                return np.where(x < 32, np.take_along_axis(a, x & 31, 1),
                                np.take_along_axis(b, x & 31, 1))
            a, b = np.where(a >= 64, a, pick(a)), np.where(b >= 64, b, pick(b))
        m = np.concatenate([a, b], 1)  # [tile, phase]
        phi = np.where(m >= 128, STOP, (m - 64) & 0xFF)
        stage = np.zeros((16, K1_TILES), np.int64)  # [phase group, tile]
        for e in range(64):
            stage[e >> 2] |= phi[:, e] << (8 * (e & 3))
        words[:, K1_TILES * blk : K1_TILES * (blk + 1)] = stage
    phiP = words.astype(np.uint32).view(np.int32)[None]
    return plane, phiP


def _walk(words, t: int, start: int, end: int):
    """One tile's walk from its entry phase: the visits (p, kind, adv, ta,
    dist) in order."""
    x = start
    for _ in range(HIER_WLK):
        if not 0 <= x < 64:
            return
        v, p = int(words[x]), 64 * t + x
        kind = K_BAD if p >= end else v >> 30
        f = (kind, (v >> 24) & 63, (v >> 15) & 511, (v & 0x7FFF) + 1)
        yield (p, *f)
        x = 64 if kind in (K_EOB, K_BAD) else x + f[1]


def model_k3d(plane, ent, end: int, out_base: int, pw: int, seed: int, stats):
    T, chunk, tokcap = hier_shape(pw)
    nb = T // RUN
    rng = np.random.default_rng(seed)
    # status words: (flag, value); before a flag is set the value is garbage
    status = [(0, int(g)) for g in rng.integers(1, 1 << 40, nb)]
    ctrl = {"eob": 0, "flags": 0, "total": 0, "arrived": 0}
    out = np.zeros((3, tokcap), np.int64)  # the caller's zeroed buffers
    writes = np.zeros(tokcap, np.int64)
    meta = []

    def block(vb):
        t0 = vb * RUN
        agg = 0
        bad = far = False
        if 64 * (t0 - t0 % chunk) >= end:  # a dead run
            status[vb] = (1, 0)
            stats["dead"] += 1
            yield
        else:
            stage = plane[64 * t0 : 64 * (t0 + RUN)].reshape(RUN, 64).copy()
            starts = [int(ent[t]) if 64 * (t - t % chunk) < end else -1
                      for t in range(t0, t0 + RUN)]
            counts = []
            for k, t in enumerate(range(t0, t0 + RUN)):
                ntok = nbytes = 0
                for p, kind, adv, ta, dist in _walk(stage[k], t, starts[k], end):
                    if kind in (K_LIT, K_MATCH):
                        ntok += 1
                        nbytes += 1 if kind == K_LIT else ta
                    bad |= kind == K_BAD
                    if kind == K_EOB:
                        ctrl["eob"] = max(ctrl["eob"], ((p << 6) | adv) + 1)
                counts.append(ntok | (nbytes << NTOK_BITS))
            base = np.concatenate([[0], np.cumsum(counts)[:-1]])
            agg = int(np.sum(counts))
            yield
            status[vb] = (2 if vb == 0 else 1, agg)
            yield
            excl = 0
            j = vb - 1
            while vb > 0:
                words = []
                for lane in range(LOOK):  # each lane polls its own word
                    i = j - lane
                    while i >= 0 and status[i][0] == 0:
                        stats["waits"] += 1
                        yield
                    words.append(status[i] if i >= 0 else (2, 0))
                    if rng.random() < 0.3:
                        yield
                pre = [f == 2 for f, _ in words]
                nearest = pre.index(True) if any(pre) else LOOK - 1
                excl += sum(v for _, v in words[: nearest + 1])
                stats["depth"] = max(stats["depth"], vb - 1 - j + nearest + 1)
                if any(pre):
                    break
                j -= LOOK
            if vb > 0:
                status[vb] = (2, excl + agg)
            yield
            for k, t in enumerate(range(t0, t0 + RUN)):
                at = excl + int(base[k])
                slot = at & ((1 << NTOK_BITS) - 1)
                run = (at >> NTOK_BITS) + out_base
                for p, kind, adv, ta, dist in _walk(stage[k], t, starts[k], end):
                    if kind in (K_LIT, K_MATCH):
                        m = kind == K_MATCH
                        far |= m and dist > run
                        if slot < tokcap:
                            out[:, slot] = (int(m), ta, dist if m else 0)
                            writes[slot] += 1
                        slot += 1
                        run += ta if m else 1
                if rng.random() < 0.1:
                    yield
        ctrl["flags"] |= int(bad) | (2 * int(far))
        ctrl["total"] += agg
        ctrl["arrived"] += 1
        if ctrl["arrived"] == nb:  # the last to arrive
            n = ctrl["total"] & ((1 << NTOK_BITS) - 1)
            eob = ctrl["eob"] - 1
            if ctrl["flags"] & 2:
                err = ERR_DIST
            elif not n < tokcap - 8:
                err = ERR_OVERFLOW
            elif ctrl["flags"] & 1:
                err = ERR_BAD_CODE
            else:
                err = ERR_OK if eob >= 0 else ERR_INPUT
            end_pos = (eob >> 6) + (eob & 63) if eob >= 0 else end
            if end <= 3:
                err, end_pos = ERR_OK, 0
            meta.extend([n, ctrl["total"] >> NTOK_BITS, end_pos, err])

    resident_cap = int(rng.integers(1, nb + 1))
    running, ticket, steps = [], 0, 0
    while ticket < nb or running:
        steps += 1
        assert steps < 10**6, "the blocks deadlocked"
        if ticket < nb and (len(running) < resident_cap and
                            (not running or rng.random() < 0.4)):
            running.append(block(ticket))  # tickets in launch order
            ticket += 1
            continue
        g = running[int(rng.integers(len(running)))]
        try:
            next(g)
        except StopIteration:
            running.remove(g)
    n = meta[0]
    assert (writes <= 1).all() and (writes[: min(n, tokcap)] == 1).all()
    return [out[i][None].astype(np.int32) for i in range(3)] + [
        np.array([v], np.int32) for v in meta]


def _check(rows, ends, tab, starts, pw, seed):
    """The K1d model on the block against the plain version, then the
    K3d model on its plane and maps against the plain version; returns
    the outputs and stats."""
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (rows, ends, tab, starts)]
    want = [x.numpy() for x in tokenize_dyn_hier_plain(*t, pw)]
    plane, phiP = model_k1d(t[0], t[1], t[2], pw)
    want_plane, want_phiP = hier_maps(t[0], t[1], t[2], pw)
    np.testing.assert_array_equal(plane.astype(np.uint32).view(np.int32),
                                  want_plane.numpy())
    np.testing.assert_array_equal(phiP, want_phiP.numpy())
    ent = ent_from_phi_plain(torch.from_numpy(phiP), t[3].reshape(()))[0, 0].numpy()
    stats = {"dead": 0, "waits": 0, "depth": 0}
    for s in range(3):  # three interleavings
        got = model_k3d(plane, ent, int(ends[0]), int(tab[0, TAB_OUTBASE]),
                        pw, seed + s, stats)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    return got, stats


def _jax(rows, ends, tab, starts, pw):
    tok, ntok, out_total, end_pos, err = (np.asarray(x) for x in j_tok_dyn(
        jnp.asarray(rows), jnp.asarray(ends), jnp.asarray(tab),
        jnp.asarray(starts), pw=pw, interpret=True, hier=True, tier=2))
    return tok[0], [int(ntok[0]), int(out_total[0]), int(end_pos[0]), int(err[0])]


def _equal_jax(got, rows, ends, tab, starts, pw):
    tok, meta = _jax(rows, ends, tab, starts, pw)
    assert [int(x[0]) for x in got[3:]] == meta
    n = min(meta[0], tok.shape[0])
    t = tok[:n]
    np.testing.assert_array_equal(got[0][0, :n], (t >> 26) & 3)
    np.testing.assert_array_equal(got[1][0, :n], (t >> 17) & 0x1FF)
    np.testing.assert_array_equal(got[2][0, :n], t & 0x1FFFF)


@pytest.mark.parametrize("name", list(HIER_CASES))
def test_model_equals_plain_and_jax_hier_cases(name):
    rows, ends, tab, starts, _ = _hier_case(name)
    got, stats = _check(rows, ends, tab, starts, HIER_PW, len(name))
    _equal_jax(got, rows, ends, tab, starts, HIER_PW)
    assert stats["dead"] == 0  # one chunk at 2^15
    if int(ends[0]) > 64 * RUN and HIER_CASES[name] == ERR_OK:
        assert stats["depth"] >= 1


EDGES = L.hier_edge_streams(RUN)
# name: (err at pw = 2^15, err at 2^16)
EDGE_ERR = {
    "eob_last_tile": (ERR_OK, ERR_OK),
    "end_on_chunk": (ERR_OVERFLOW, ERR_INPUT),
    "bad_code_second_run": (ERR_BAD_CODE, ERR_BAD_CODE),
    "far_second_run": (ERR_DIST, ERR_DIST),
    "reach_second_run": (ERR_OK, ERR_OK),
    "empty_end0": (ERR_OK, ERR_OK),
    "empty_end3": (ERR_OK, ERR_OK),
}


@pytest.mark.parametrize("pw", [1 << 15, 1 << 16])
@pytest.mark.parametrize("name", list(EDGES))
def test_model_equals_plain_edges(name, pw):
    stream, end, out_base = EDGES[name]
    lane = L.hier_lane(stream, pw, end, out_base)
    got, stats = _check(*lane, pw, pw + len(name))
    ntok, out_total, end_pos, err = (int(x[0]) for x in got[3:])
    assert err == EDGE_ERR[name][pw == 1 << 16]
    T, chunk, _ = hier_shape(pw)
    if name == "eob_last_tile":
        assert end_pos // 64 == 2 * RUN - 1  # the second run's last tile
    if name == "end_on_chunk" and pw == 1 << 16:
        assert stats["dead"] == 3 * (T - chunk) // RUN  # a second chunk, dead
    if name.startswith("empty"):
        assert end_pos == 0 and (ntok == 0) == (name == "empty_end0")
    if name in ("far_second_run", "reach_second_run"):
        assert out_base > 0 and ntok > 0
    if pw == 1 << 15 or name == "end_on_chunk":
        _equal_jax(got, *lane, pw)


K1D_LANES = L.k1d_edge_lanes(1 << 15)


@pytest.mark.parametrize("name", list(K1D_LANES))
def test_k1d_model_equals_plain_and_jax_edges(name):
    """The K1d model against hier_maps_plain on its edge lanes, and with
    the K3d model against the JAX package."""
    pw = 1 << 15
    lane = K1D_LANES[name]
    got, _ = _check(*lane, pw, len(name))
    _equal_jax(got, *lane, pw)
    t = [torch.from_numpy(x) for x in lane[:3]]
    plane, phiP = hier_maps_plain(*t, pw)
    kind, adv = (plane >> 30) & 3, (plane >> 24) & 63
    phase = torch.arange(pw) % 64
    maps = [(phiP >> (8 * j)) & 0xFF for j in range(4)]
    end, end_pos = int(lane[1][0]), int(got[5][0])
    if name == "one_bit_code":  # chains that stay in their tile 32 links
        assert any(bool((m >= 192).any()) for m in maps)
    if name.startswith("eob_phase"):
        at = end_pos - 3  # the end-of-block's 3 bits
        assert int(kind[at]) == K_EOB and at % 64 == int(name[9:])
    if name == "wide":
        assert bool(((adv == 48) & (kind == K_MATCH) & (phase + 48 > 64)).any())
    if name == "end_mid_tile":
        assert end % 64 == 37 and end_pos == end
    if name == "end_on_block":
        assert end % (64 * K1_TILES) == 0 and int(kind[end]) == K_BAD
