"""A numpy model of the exact far matcher's schedule on the card
(``tpu_deflate_torch/csrc/farmatch.cu``, ``kernels/farmatch.py``): the
keys launch (the 3-byte key and the 6- and 10-byte multiplicative hashes
of each position in uint32 arithmetic, each replaced by its sentinel where
it crosses n), a stable sort of each key plane, the previous-occurrence
launch (each sorted entry's position takes the entry before it where the
keys are equal), then the match launch: tiles of 4096 positions staged as
bytes with the window before them and max_match + 8 after (zeros outside
the row), each position's 3-byte chain followed through the previous
occurrences up to 4 links and stopped at the first past the window, the
hashed keys' occurrences taken within the window, each candidate checked
on its 3 bytes and probed to 16 by 4-byte words from the staged bytes,
the longest kept (the nearer among equal lengths), the winner extended
to max_match, clipped at n.

The model must equal the plain version, ``ops.encode._match_candidates_multi``,
and the JAX package's ``_match_candidates_multi`` at windows 300, 1024 and
32768 with max_match 12 and 258, on lanes of ten tiles (the last partial):
corpus text, corpus text cut short (bytes past n are 7), zeros, long runs
cut short, random bytes with a block repeated exactly ``window`` and
``window + 1`` back, random bytes holding two 6-byte keys whose 31-bit
hashes collide (found by a seeded search), and a lane of 2 bytes."""

from __future__ import annotations

import functools
import gzip
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_deflate.ops.encode as JE  # noqa: E402
import tpu_deflate_torch.ops.encode as TE  # noqa: E402
from tpu_deflate_torch.kernels.farmatch import far_match_batch  # noqa: E402

TILE, DEPTH, PROBE = 4096, 4, 16  # csrc/farmatch.cu's kTile, kDepth, kProbe
MUL = np.uint64(0x9E3779B1)
U32 = np.uint64(0xFFFFFFFF)
N = 9 * TILE + 1000  # ten tiles, the last partial
CORPUS = pathlib.Path(__file__).resolve().parent / "data" / "corpus.bin.gz"


def _mix(acc):
    return (acc ^ (acc >> np.uint64(15))) & np.uint64(0x7FFFFFFF)


def model_keys(data, n):
    """The keys launch: int64[3, B, N] of the 3-byte key and the 6- and
    10-byte hashes, one running uint32 product over bytes i .. i + 9
    (zero past the row)."""
    B, L = data.shape
    pad = np.zeros((B, L + 10), np.uint64)
    pad[:, :L] = data
    acc = np.zeros((B, L), np.uint64)
    for k in range(10):
        acc = (acc * MUL + pad[:, k : k + L]) & U32
        if k == 5:
            h6 = _mix(acc)
    key3 = pad[:, :L] | pad[:, 1 : L + 1] << np.uint64(8) | pad[:, 2 : L + 2] << np.uint64(16)
    i = np.arange(L)
    nn = np.asarray(n, np.int64)[:, None]
    return np.stack([np.where(i + 3 <= nn, key3.astype(np.int64), (1 << 24) + i),
                     np.where(i + 6 <= nn, h6.astype(np.int64), -(i + 2)),
                     np.where(i + 10 <= nn, _mix(acc).astype(np.int64), -(i + 2))])


def model_prev(keys):
    """The stable sort and the previous-occurrence launch, a row at a time."""
    prev = np.full(keys.shape, -1, np.int64)
    for plane, row in np.ndindex(keys.shape[:2]):
        order = np.argsort(keys[plane, row], kind="stable")
        sk = keys[plane, row, order]
        prev[plane, row, order[1:]] = np.where(sk[1:] == sk[:-1], order[:-1], -1)
    return prev


def _load4(sw, q):
    """The 4 bytes at byte offset q of the staged words (a funnel shift of
    two words), elementwise."""
    lo, hi = sw[q >> 2], sw[(q >> 2) + 1]
    return ((hi << np.uint64(32) | lo) >> (8 * (q & 3)).astype(np.uint64)) & U32


def _common(sw, ji, d, start, kmax, active):
    """The kernel's probe: from ``start``, 4 bytes a compare until a word
    differs (its first differing byte by the lowest set bit) or kmax."""
    L = np.full(ji.shape, start, np.int64)
    go = active & (L < kmax)
    while go.any():
        a = np.where(go, ji + L, 0)
        x = _load4(sw, a) ^ _load4(sw, np.where(go, a - d, 0))
        low = x & (~x + np.uint64(1)) & U32
        tz = np.log2(np.where(x != 0, low, 1)).astype(np.int64)
        L = np.where(go, L + np.where(x != 0, tz >> 3, 4), L)
        go &= (x == 0) & (L < kmax)
    return np.minimum(L, kmax)


def model_match(data, n, window, max_match, stats=None):
    """(dist, length) int32[B, N] by the three launches' schedule; stats,
    where given, gets each lane's previous occurrences."""
    B, L = data.shape
    prev = model_prev(model_keys(data, n))
    lhalo = (window + 15) & ~15
    nstage = lhalo + TILE + ((max_match + 8 + 15) & ~15)
    probe = min(PROBE, max_match)
    dist = np.zeros((B, L), np.int32)
    length = np.zeros((B, L), np.int32)
    for b in range(B):
        nb = int(n[b])
        p3, p6, p10 = prev[0, b], prev[1, b], prev[2, b]
        for x0 in range(0, L, TILE):
            lo = x0 - lhalo
            p = lo + np.arange(nstage)
            sb = np.where((p >= 0) & (p < L), data[b, np.clip(p, 0, L - 1)], 0)
            sw = sb.astype(np.uint8).view("<u4").astype(np.uint64)
            pos = x0 + np.arange(min(TILE, L - x0))
            live = pos + 3 <= nb
            ji = pos - lo
            key = _load4(sw, ji) & np.uint64(0xFFFFFF)
            kmax = np.minimum(probe, nb - pos)
            best_d = np.zeros(len(pos), np.int64)
            best_len = np.zeros(len(pos), np.int64)

            def consider(c, active):
                nonlocal best_d, best_len
                d = pos - c
                ok = active & (_load4(sw, np.where(active, ji - d, 0))
                               & np.uint64(0xFFFFFF) == key)
                ln = _common(sw, ji, d, 3, kmax, ok)
                better = ok & ((ln > best_len) | ((ln == best_len) & (d < best_d)))
                best_len = np.where(better, ln, best_len)
                best_d = np.where(better, d, best_d)

            c = p3[pos]
            act = live.copy()
            for k in range(DEPTH):  # the chain, stopped past the window
                act &= (c >= 0) & (pos - c <= window)
                consider(c, act)
                c = np.where(act, p3[np.clip(c, 0, L - 1)], -1)
            for ph in (p6, p10):
                c = ph[pos]
                consider(c, live & (c >= 0) & (pos - c <= window))
            ext = live & (max_match > probe) & (best_len == probe)
            best_len = np.where(ext, _common(sw, ji, best_d, probe,
                                             np.minimum(max_match, nb - pos), ext),
                                best_len)
            dist[b, pos], length[b, pos] = best_d, best_len
        if stats is not None:
            stats.append(prev[:, b])
    return dist, length


def _hash(strings):
    """The 31-bit hash of each row of uint8[K, nbytes]."""
    acc = np.zeros(len(strings), np.uint64)
    for k in range(strings.shape[1]):
        acc = (acc * MUL + strings[:, k].astype(np.uint64)) & U32
    return _mix(acc)


@functools.lru_cache(maxsize=None)
def colliding_keys(nbytes: int, prefix: tuple = ()):
    """Two distinct keys of nbytes with equal 31-bit hashes, both starting
    with prefix, by a seeded birthday search over 2^18 random keys."""
    rng = np.random.default_rng(1951 + nbytes)
    s = rng.integers(0, 256, (1 << 18, nbytes)).astype(np.uint8)
    s[:, : len(prefix)] = prefix
    s = np.unique(s, axis=0)
    h = _hash(s)
    order = np.argsort(h, kind="stable")
    hit = np.nonzero(h[order][1:] == h[order][:-1])[0]
    assert len(hit), "no collision in the search"
    x, y = s[order[hit[0]]], s[order[hit[0] + 1]]
    assert (x != y).any() and _hash(x[None])[0] == _hash(y[None])[0]
    return x, y


# the 6-byte key at p1, a key of another 3-byte prefix and the same hash
# at p2, the key again at p3; the same for 10-byte keys of one prefix at q
COLLIDE6 = (1000, 1100, 1150)
COLLIDE10 = (2000, 2100, 2150)


@functools.lru_cache(maxsize=None)
def _raw() -> bytes:
    return gzip.decompress(CORPUS.read_bytes())[: 1 << 17]


@functools.lru_cache(maxsize=None)
def lanes(window: int):
    """(data uint8[8, N], n int32[8], the starts of the repeats exactly
    window and window + 1 back)."""
    rng = np.random.default_rng(window)
    raw = np.frombuffer(_raw(), np.uint8)
    data = np.full((8, N), 7, np.uint8)
    n = np.full(8, N, np.int32)
    data[0] = raw[:N]                                  # corpus text
    n[1] = N - TILE - 3                                # cut short, 7 past n
    data[1, : n[1]] = raw[50000 : 50000 + n[1]]
    data[2] = 0                                        # zeros
    n[2] = N - 1
    runs = np.repeat(rng.integers(0, 256, N), rng.integers(1, 300, N))[:N]
    n[3] = N - 2 * TILE + 17                           # long runs, cut short
    data[3, : n[3]] = runs[: n[3]]
    data[4] = rng.integers(0, 256, N)                  # repeats at window, window + 1
    at = (500, 2000)
    for a, back in zip(at, (window, window + 1)):
        data[4, a + back : a + back + 200] = data[4, a : a + 200]
    data[5] = rng.integers(0, 256, N)                  # keys whose hashes collide
    for (p1, p2, p3), (x, y) in ((COLLIDE6, colliding_keys(6)),
                                 (COLLIDE10, colliding_keys(10, (0x51, 0x7A, 0x03)))):
        data[5, p1 : p1 + len(x)], data[5, p2 : p2 + len(y)] = x, y
        data[5, p3 : p3 + len(x)] = x
        for k in range(4):  # decoys of its 3-byte key: the chain stops short of p1
            data[5, p1 + 20 + 20 * k : p1 + 23 + 20 * k] = x[:3]
    data[6] = raw[20000 : 20000 + N]                   # corpus text, a tile cut off
    n[6] = N - TILE
    n[7] = 2                                           # no position can match
    return data, n, tuple(a + b for a, b in zip(at, (window, window + 1)))


@functools.lru_cache(maxsize=None)
def _jax_match(window: int, max_match: int):
    data, n, _ = lanes(window)

    def lane(d, nn):
        b = d.astype(jnp.int32)
        idx = jnp.arange(b.shape[0], dtype=jnp.int32)
        b1 = jnp.concatenate([b[1:], jnp.zeros((1,), jnp.int32)])
        b2 = jnp.concatenate([b[2:], jnp.zeros((2,), jnp.int32)])
        key3 = b | (b1 << 8) | (b2 << 16)
        key3 = jnp.where(idx + 3 <= nn, key3, (1 << 24) + idx)
        return JE._match_candidates_multi(b, key3, nn, window, max_match)

    dist, length = jax.jit(jax.vmap(lane))(jnp.asarray(data), jnp.asarray(n))
    return np.asarray(dist), np.asarray(length)


@pytest.mark.parametrize("max_match", [12, 258])
@pytest.mark.parametrize("window", [300, 1024, 32768])
def test_model_equals_plain_and_jax(window, max_match):
    data, n, (at_window, past_window) = lanes(window)
    stats = []
    dist, length = model_match(data, n, window, max_match, stats)
    pd, pl = TE._far_match_plain(torch.from_numpy(data), torch.from_numpy(n),
                                 window, max_match)
    np.testing.assert_array_equal(length, pl.numpy())
    np.testing.assert_array_equal(dist, pd.numpy())
    jd, jl = _jax_match(window, max_match)
    np.testing.assert_array_equal(length, jl)
    np.testing.assert_array_equal(dist, jd)

    assert dist.max() <= window and length.max() == max_match
    # the repeat exactly window back is found; the one a byte farther not
    assert dist[4, at_window] == window and length[4, at_window] >= min(200, max_match)
    assert length[4, past_window] == 0
    # the collisions: at p3 the most recent equal 6-byte hash is p2's key
    # of another prefix, which shadows p1's true 6-byte match, as in the
    # plain version; at q3 the most recent equal 10-byte hash is q2's key
    # of the same prefix, a candidate that passes and probes short
    p1, p2, p3 = COLLIDE6
    assert stats[5][1, p3] == p2 and data[5, p2 : p2 + 3].tolist() != data[5, p3 : p3 + 3].tolist()
    assert length[5, p3] < 6 and dist[5, p3] != p3 - p1
    q1, q2, q3 = COLLIDE10
    assert stats[5][2, q3] == q2 and data[5, q2 : q2 + 3].tolist() == data[5, q3 : q3 + 3].tolist()
    # matches that run over a tile's edge (the right halo), and one at a
    # tile's first position from a source in the tile before (the left)
    i = np.nonzero((length[2] >= 3) & ((np.arange(N) % TILE) + length[2] > TILE))[0]
    assert len(i) and (length[2, i] == np.minimum(max_match, n[2] - i)).all()
    assert dist[2, TILE] == 1 and length[2, TILE] == max_match
    # lanes cut short: nothing at or past n, bytes past n never read
    for b in range(len(n)):
        assert not length[b, max(int(n[b]) - 2, 0) :].any()
        assert (np.arange(N) + length[b] <= n[b])[length[b] > 0].all()


def test_keys_and_previous_occurrences_equal_the_plain_ones():
    """The keys launch and the sort with the previous-occurrence launch,
    against the plain version's ``_key3``, ``_key_hash`` and
    ``_prev_occurrence``."""
    data, n, _ = lanes(1024)
    b = torch.from_numpy(data).to(torch.int64)
    n64 = torch.from_numpy(n).to(torch.int64)[:, None]
    want = [TE._key3(b, n64), TE._key_hash(b, n64, 6), TE._key_hash(b, n64, 10)]
    keys = model_keys(data, n)
    prev = model_prev(keys)
    for plane, w in enumerate(want):
        np.testing.assert_array_equal(keys[plane], w.numpy())
        np.testing.assert_array_equal(prev[plane], TE._prev_occurrence(w).numpy())


def test_the_wrapper_takes_only_card_tensors():
    """CPU lanes take the plain version in ``_match_lanes``; the kernel's
    wrapper raises on them rather than falling back."""
    data, n, _ = lanes(300)
    with pytest.raises(ValueError, match="expected cuda"):
        far_match_batch(torch.from_numpy(data), torch.from_numpy(n), 300, 12)
    with pytest.raises(ValueError, match="outside"):
        far_match_batch(torch.from_numpy(data), torch.from_numpy(n), 40000, 12)
    got = TE._match_lanes(torch.from_numpy(data[:2]), torch.from_numpy(n[:2]), 300, 12,
                          True, "exact", False)
    want = TE._far_match_plain(torch.from_numpy(data[:2]), torch.from_numpy(n[:2]), 300, 12)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
