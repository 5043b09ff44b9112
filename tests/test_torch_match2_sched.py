"""A numpy model of the ``match_bitplane_batch`` kernel's schedule
(``tpu_deflate_torch/csrc/match2.cu``): tiles of 4096 positions staged
with their halos (zeros outside the row), 512 positions to a warp, each
warp linking its positions and the window before them (rounded up to 32)
to the nearest earlier position of the same 10-bit key hash, 32 positions
a step in order (the lanes of equal hash in a step found as the
kernel's mask a hash finds them, each lane setting its bit, the latest
position of each hash before the step from the warp's table), positions with i < 0 or i + 3 > n left
out; then each position's chain walked, nearest first, to the first equal
3-byte key or a distance past the window, and the match extended four
bytes a compare, clipped to min(max_match, n - i).

The model must equal ``match_bitplane_plain`` on seeded lanes at the
(window, max_match) corners (1, 3), (100, 10), (256, 10) and (256, 258):
lanes shorter than the row whose bytes past n are 7, a partial last tile,
zeros, random bytes and runs; and, up to max_match 10, the JAX package's
``match_bitplane_batch`` in interpret mode and its
``_match_extend_bitplane``.  At max_match 258 both JAX functions unroll
255 extension steps: one lane took 31 s op by op on a CPU, and a jit
compile longer, so that corner is held to the plain version alone."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.corpora import corpus  # noqa: E402
from tpu_deflate.kernels.match2 import match_bitplane_batch as j_match  # noqa: E402
from tpu_deflate.ops.encode import _match_extend_bitplane  # noqa: E402
from tpu_deflate_torch.kernels.match2 import match_bitplane_plain  # noqa: E402

TILE, WARPS, WARP, HASH_BITS = 4096, 8, 32, 10
OWN = TILE // WARPS
NONE = 0xFFFF
U32 = np.uint64(0xFFFFFFFF)


def _round16(x):
    return (x + 15) & ~15


def _load4(sw, q):
    """The 4 bytes at byte offset q of the staged words (a funnel shift of
    two words), elementwise."""
    q = np.asarray(q)
    lo, hi = sw[q >> 2], sw[(q >> 2) + 1]
    return ((hi << np.uint64(32) | lo) >> (8 * (q & 3)).astype(np.uint64)) & U32


def model_match(data, n, window, max_match, stats):
    """(dist, length) int32[B, N] by the kernel's schedule; stats gets
    (lane, the chain steps of each walk) per warp."""
    B, N = data.shape
    whalo = (window + 31) & ~31
    lhalo = _round16(whalo + 3)
    nstage = lhalo + TILE + _round16(max_match + 8)
    span = whalo + OWN
    dist = np.zeros((B, N), np.int32)
    length = np.zeros((B, N), np.int32)
    lane = np.arange(WARP)
    for b in range(B):
        nb = int(n[b])
        for x0 in range(0, N, TILE):
            lo = x0 - lhalo
            p = lo + np.arange(nstage)
            sb = np.where((p >= 0) & (p < N), data[b, np.clip(p, 0, N - 1)], 0)
            sw = sb.astype(np.uint8).view("<u4").astype(np.uint64)
            for w in range(WARPS):
                start = x0 + OWN * w - whalo
                i = start + np.arange(span)
                ok = (i >= 0) & (i + 3 <= nb)
                key = _load4(sw, i - lo) & np.uint64(0xFFFFFF)
                h = ((key * np.uint64(2654435761)) & U32) >> np.uint64(32 - HASH_BITS)
                h = h.astype(np.int64)
                tab = np.full(1 << HASH_BITS, NONE, np.int64)
                ch = np.full(span, NONE, np.int64)
                for s in range(0, span, WARP):  # link, 32 positions a step
                    hs = np.where(ok[s : s + WARP], h[s : s + WARP],
                                  (1 << HASH_BITS) + lane)
                    same = hs[:, None] == hs[None, :]  # the mask of hs
                    lower = same & (lane[None, :] < lane[:, None])
                    nearest = np.where(lower.any(1),
                                       s + WARP - 1 - np.argmax(lower[:, ::-1], 1),
                                       tab[np.minimum(hs, (1 << HASH_BITS) - 1)])
                    ch[s : s + WARP] = np.where(ok[s : s + WARP], nearest, NONE)
                    top = ok[s : s + WARP] & ~(same & (lane[None, :] > lane[:, None])).any(1)
                    tab[hs[top]] = s + lane[top]
                L = whalo + np.arange(OWN)  # walk, one position a lane
                pos = start + L
                live = (pos < N) & (pos + 3 <= nb)
                q = ch[L]
                d = np.zeros(OWN, np.int64)
                steps = np.zeros(OWN, np.int64)
                active = live & (q != NONE)
                while active.any():
                    steps += active
                    dd = L - q
                    near = dd <= window
                    eq = key[np.minimum(q, span - 1)] == key[L]
                    d = np.where(active & near & eq, dd, d)
                    active &= near & ~eq
                    q = np.where(active, ch[np.minimum(q, span - 1)], q)
                    active &= q != NONE
                stats.append((b, steps[live]))
                # the extension, four bytes a compare
                k = np.nonzero(d)[0]
                ji, dk = pos[k] - lo, d[k]
                kmax = np.minimum(max_match, nb - pos[k])
                ln = np.full(len(k), 3)
                go = ln < kmax
                while go.any():
                    x = _load4(sw, ji + ln) ^ _load4(sw, ji + ln - dk)
                    low = x & (~x + np.uint64(1)) & U32  # the lowest set bit
                    tz = np.log2(np.where(x != 0, low, 1)).astype(np.int64)
                    ln = np.where(go, ln + np.where(x != 0, tz >> 3, 4), ln)
                    go &= (x == 0) & (ln < kmax)
                dist[b, pos[k]], length[b, pos[k]] = dk, np.minimum(ln, kmax)
    return dist, length


def _lanes(N):
    """Corpus modes, lanes cut short (bytes past n are 7), zeros, runs."""
    rng = np.random.default_rng(11)
    modes = (0, 1, 3, 6)
    data = np.full((len(modes) + 2, N), 7, np.uint8)
    n = np.zeros(len(modes) + 2, np.int32)
    for r, mode in enumerate(modes):
        raw = np.frombuffer(corpus(mode, N - 37 * r), np.uint8)
        data[r, : len(raw)] = raw
        n[r] = len(raw)
    data[-2] = 0  # zeros: every position matches at distance 1
    n[-2] = N
    runs = np.repeat(rng.integers(0, 3, N // 8 + 1), 8)[:N]
    data[-1, : N - 300] = runs[: N - 300]
    n[-1] = N - 300
    return data, n


@pytest.mark.parametrize("window,max_match", [(1, 3), (100, 10), (256, 10),
                                              (256, 258)])
def test_model_equals_plain_and_jax(window, max_match):
    N = TILE + 1024  # two tiles, the second partial
    data, n = _lanes(N)
    stats = []
    got = model_match(data, n, window, max_match, stats)
    plain = match_bitplane_plain(torch.from_numpy(data), torch.from_numpy(n),
                                 window, max_match)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())
    if max_match <= 10:
        jd, jl = j_match(jnp.asarray(data), jnp.asarray(n), window, max_match,
                         interpret=True)
        np.testing.assert_array_equal(got[0], np.asarray(jd))
        np.testing.assert_array_equal(got[1], np.asarray(jl))
        for b in range(len(n)):  # eagerly, one lane at a time
            jd, jl = _match_extend_bitplane(jnp.asarray(data[b], jnp.int32),
                                            jnp.int32(n[b]), window, max_match)
            np.testing.assert_array_equal(got[0][b], np.asarray(jd))
            np.testing.assert_array_equal(got[1][b], np.asarray(jl))
    # the zero lane: every walk ends at its first step (distance 1), but
    # position 0's, which has no chain; random bytes: a walk takes a step
    # for each earlier key of its hash in the window, a fraction on average
    steps = {b: np.concatenate([st for lb, st in stats if lb == b]) for b in range(len(n))}
    assert steps[len(n) - 2].max() == 1 and (steps[len(n) - 2] == 0).sum() == 1
    assert got[0][-2, 1:].max() == 1 and got[1][-2].max() == max_match
    assert steps[2].mean() <= 1 + window / (1 << HASH_BITS)
