"""A numpy model of the ``mono_scatter_add`` kernel's schedule
(``tpu_deflate_torch/csrc/monotone.cu``): slabs of 2048 entries a block,
indices clamped to [-1, size]; a block owns the output elements from the
one after the index before its slab up to its last index, and takes each
run's sum as a difference of the block's running sums (a segmented
reduction: 8 consecutive entries a thread, a prefix sum over the block,
mod 2^32), the run's first entry storing -P[s - 1] and its last adding
P[e] into a window of 4096 of the owned range.  A first launch sums each
slab's leading run (the entries that continue the index before the slab),
one warp a slab; where a slab's last run goes on past the slab, one warp
finds its end (the next 32 entries, then a 32-way search over the clamped
indices) and the block adds the leading sums of the slabs it reaches.
The zeros after the lane's last entry are shared out evenly among the
lane's blocks.

The model counts every store: each output element must be written exactly
once (the kernel's output is ``torch.empty``), and each window slot by one
run's first entry and one run's last, or by neither.  It must equal
``mono_scatter_add_plain`` and the JAX package's ``mono_scatter_add_xla``
on seeded entries with a dead head and tail, a lane with no live entry,
gaps of up to 100 elements, runs of one index longer than a slab, K a
multiple of the slab and K = 0, and on the encoder's own entries, static
(C = 2) and dynamic (C = 3) at max_match 258 over zeros and on a lane cut
short, whose run past n spans most of the lane."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_deflate.kernels.monotone import mono_scatter_add_xla  # noqa: E402
from tpu_deflate_torch.config import DeflateConfig  # noqa: E402
from tpu_deflate_torch.kernels.match2 import match_bitplane_plain  # noqa: E402
from tpu_deflate_torch.kernels.monotone import mono_scatter_add_plain  # noqa: E402
from tpu_deflate_torch.ops import encode as E  # noqa: E402

THREADS, PER, WARP = 256, 8, 32
SLAB = THREADS * PER
WINDOW = 4096
M32 = (1 << 32) - 1


def run_end(keys, a, last, stats):
    """The first entry at or after a whose key is not ``last``, by the
    kernel's search: the next 32 entries, then 32 probes a step, each the
    first entry of a piece of the interval left."""
    K = len(keys)
    p = a + np.arange(WARP)
    out = (p >= K) | (keys[np.minimum(p, K - 1)] != last)
    probes = 1
    if out.any():
        return a + int(np.argmax(out))
    L, H = a + WARP, K
    while L < H:
        step = (H - L + WARP - 1) // WARP
        q = L + np.arange(WARP) * step
        out = (q < H) & (keys[np.minimum(q, K - 1)] != last)
        probes += 1
        stats["deepest"] = max(stats["deepest"], probes)
        f = int(np.argmax(out)) if out.any() else WARP
        in_run = min(f - 1, (H - L - 1) // step)
        if f < WARP:
            H = L + f * step
        if f > 0:
            L += in_run * step + 1
    return H


def model_pack(idx, vals, size, stats):
    """out int32[B, C, size] by the kernel's schedule; stats counts the
    passes of a window, the ranges wider than one, the blocks that add the
    leading sums of later slabs, and the most dependent probes of one
    search."""
    B, C, K = vals.shape
    out = np.zeros((B, C, size), np.int64)
    writes = np.zeros((B, C, size), np.int64)
    nblk = max(1, -(-K // SLAB))
    for b in range(B):
        keys = np.clip(idx[b].astype(np.int64), -1, size)
        # the first launch: each slab's leading run, summed by one warp
        lead = np.zeros((nblk, C), np.int64)
        for slab in range(1, nblk):
            s0 = slab * SLAB
            if 0 <= keys[s0 - 1] < size:
                e = run_end(keys[: min(s0 + SLAB, K)], s0, keys[s0 - 1], stats)
                lead[slab] = vals[b, :, s0:e].astype(np.int64).sum(1)

        def store(c, j, v):
            out[b, c, j] = v
            writes[b, c, j] += 1

        t0 = keys[K - 1] + 1 if K else 0
        share = -(-(size - t0) // nblk) if t0 < size else 0
        for slab in range(nblk):
            a = t0 + slab * share  # the block's share of the zeros at the end
            for c in range(C):
                for j in range(a, min(a + share, size)):
                    store(c, j, 0)
            s0 = slab * SLAB
            n = max(0, min(SLAB, K - s0))
            before = keys[s0 - 1] if s0 else -1
            last = keys[s0 + n - 1] if n else before
            lo, hi = before + 1, min(last, size - 1)  # the owned range
            if lo > hi:
                continue
            e_end = s0 + n
            if last < size and s0 + n < K:
                e_end = run_end(keys, s0 + n, last, stats)
                stats["tails"] += e_end > s0 + n
            stop = (e_end - 1) // SLAB  # the last slab the run reaches
            k = np.full(SLAB + 1, size + 1)  # the slab's keys, a sentinel past n
            k[:n] = keys[s0 : s0 + n]
            first = k[:SLAB] != np.concatenate([[before], k[: SLAB - 1]])
            end = k[:SLAB] != k[1:]
            for c in range(C):
                v = np.zeros(SLAB, np.int64)
                v[:n] = vals[b, c, s0 : s0 + n]
                tail = int(lead[slab + 1 : stop + 1, c].sum())
                # each thread's running sums, then the block's prefix sum
                p = np.cumsum(v.reshape(THREADS, PER), 1)
                base = np.concatenate([[0], np.cumsum(p[:, -1])[:-1]])
                p = ((p + base[:, None]).reshape(SLAB)) & M32
                p_excl = (p - v) & M32
                stats["wide"] += hi - lo + 1 > WINDOW
                for wlo in range(lo, hi + 1, WINDOW):
                    stats["passes"] += 1
                    w = min(WINDOW, hi - wlo + 1)
                    acc = np.zeros(w, np.int64)
                    starts = np.zeros(w, np.int64)
                    ends = np.zeros(w, np.int64)
                    j = k[:SLAB] - wlo
                    inw = (j >= 0) & (j < w)
                    for i in np.nonzero(inw & first)[0]:
                        acc[j[i]] = -p_excl[i] & M32
                        starts[j[i]] += 1
                    for i in np.nonzero(inw & end)[0]:
                        acc[j[i]] = (acc[j[i]] + p[i] + (tail if i == n - 1 else 0)) & M32
                        ends[j[i]] += 1
                    np.testing.assert_array_equal(starts, ends)
                    assert starts.max(initial=0) <= 1
                    for jj in range(w):
                        store(c, wlo + jj, acc[jj])
    np.testing.assert_array_equal(writes, 1)  # every element, exactly once
    return out.astype(np.uint32).view(np.int32)


def _check(idx, vals, size):
    stats = {"passes": 0, "tails": 0, "deepest": 1, "wide": 0}
    got = model_pack(idx, vals, size, stats)
    plain = mono_scatter_add_plain(torch.from_numpy(idx), torch.from_numpy(vals), size)
    np.testing.assert_array_equal(got, plain.numpy())
    if idx.shape[1]:
        want = mono_scatter_add_xla(jnp.asarray(idx), jnp.asarray(vals), size)
        np.testing.assert_array_equal(got, np.asarray(want))
    return stats


@pytest.mark.parametrize("seed,C,K", [(0, 2, 6000), (1, 3, 4096), (2, 1, 2047)])
def test_model_seeded(seed, C, K):
    """Advances of 0-4 with some gaps of up to 100; lane 0 a dead head of
    mixed negatives and lane 1 a dead tail (size + 5, size); lane 2 a run
    of one index over 5000 entries; lane 3 no live entry."""
    rng = np.random.default_rng(seed)
    B = 4
    step = rng.integers(0, 5, (B, K))
    step[:, ::97] = rng.integers(17, 101, (B, len(range(0, K, 97))))
    idx = np.cumsum(step, axis=1)
    size = int(idx[:, -1].max()) + 40
    idx[0, :50] = rng.integers(-9, 0, 50)
    idx[1, -300:] = size + 5
    idx[1, -100:] = size
    idx[2, 100 : 100 + min(5000, K - 200)] = idx[2, 100]
    idx[2, 100 + min(5000, K - 200) :] += idx[2, 100] - idx[2, 100 + min(5000, K - 200)]
    idx[3] = -1 if seed % 2 else size + 1
    vals = rng.integers(0, 1 << 16, (B, C, K))
    vals[:, :, ::7] = 0
    stats = _check(idx.astype(np.int32), vals.astype(np.int32), size)
    assert stats["tails"] > 0 or K <= SLAB  # lane 2's run over slabs
    assert stats["wide"] > 0 or seed % 2  # lane 3 all past size: one range


def test_model_empty_lanes():
    """K = 0: the lane's one block writes the whole output, zeros."""
    idx = np.zeros((2, 0), np.int32)
    vals = np.zeros((2, 3, 0), np.int32)
    _check(idx, vals, 77)


@pytest.mark.parametrize("dynamic", [False, True])
def test_model_encoder_entries(dynamic):
    """The encoder's bit-pack entries at window 256, max_match 258: zeros
    (runs of 257 entries, or 515 with two a position), runs of 16 bytes
    from {0, 1, 2, 3}, and two lanes cut short, at 1000 and at N / 8: every
    entry past n takes the offset of the end-of-block code, so one run
    spans most of the lane, several slabs, and its search goes on past its
    first 32 entries, one dependent probe a factor of 32."""
    N = 4096
    data = np.zeros((4, N), np.uint8)
    rng = np.random.default_rng(3)
    data[1] = data[3] = np.repeat(rng.integers(0, 4, N // 16), 16)
    n = np.array([N, N, 1000, N // 8], np.int32)
    t = torch.from_numpy
    dist, length = match_bitplane_plain(t(data), t(n), 256, 258)
    vals, nbs, offs, _, _ = E._encode_emissions(
        t(data), t(n), t(np.array([True, False, True, True])), dist, length,
        dynamic)
    cfg = DeflateConfig(window=256, max_match=258, dynamic_encode=dynamic)
    idx, ch = E._bitpack_entries(vals, nbs, offs, E._emission_bits(cfg))
    assert ch.shape[1] == 3
    idx, ch = idx.numpy(), ch.numpy()
    runs = np.unique(idx[0], return_counts=True)[1].max()
    assert runs >= (515 if dynamic else 257)
    stats = _check(idx, ch, E.max_output_bytes(N) + 8)
    K = idx.shape[1]
    assert np.unique(idx[3], return_counts=True)[1].max() > (N - N // 8) * (1 + dynamic)
    assert stats["tails"] > 0
    assert 2 < stats["deepest"] <= 2 + int(np.ceil(np.log(K) / np.log(WARP)))
