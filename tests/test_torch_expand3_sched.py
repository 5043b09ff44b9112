"""A numpy model of the ``expand_fused3`` kernel's schedule
(``tpu_deflate_torch/csrc/expand3.cu``): every byte below the total seeded
as a root of value 0; the tokens scattered, those of at most LONG bytes a
thread each in turn and the longer ones from a queue, a warp each (a
literal or stored byte carries its value, byte j of a match at offset o
with distance d points at o - d + (j mod d), or at byte 0 where that lies
before the row); pointer jumping until a round moves nothing; each byte
its root's value, zero past the total.  The jumping is modelled in rounds
that read the last round's parents only, which takes at least as many
rounds as the kernel's in-place sweep.

The model must equal ``expand_fused3_plain``, and the JAX package's
``expand_fused3`` in interpret mode on random token streams, a
distance-1 run over a whole row of 2^14 bytes, a match reaching before
the row, an empty lane, and a lane whose tokens run past the row; and the
JAX package's ``expand_batch`` on a stored token as wide as the row (the
JAX kernel takes no stored tokens) and on a distance-1 run over a whole
row of 2^16 bytes (where the JAX kernel leaves the second half zero)."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.test_expand3 import make_tokens  # noqa: E402
from tpu_deflate.kernels.expand3 import expand_fused3 as j_expand3  # noqa: E402
from tpu_deflate.ops.decode import expand_batch as j_expand_batch  # noqa: E402
from tpu_deflate_torch.kernels.expand3 import expand_fused3_plain  # noqa: E402
from tpu_deflate_torch.ops import expand as X  # noqa: E402

THREADS, WARP, LONG = 1024, 32, 32


def model_expand(rows, off, c1, tb, tp, total, out_cap, stats):
    """The kernel on each lane: uint8[B, out_cap]; stats gets (rounds,
    queued tokens) per lane."""
    B, K = off.shape
    M = rows.shape[1]
    out = np.zeros((B, out_cap), np.uint8)
    for b in range(B):
        ntok = min(max(int(tp[b]), 0), K)
        tot = min(max(int(total[b]), 0), out_cap)
        par = np.arange(tot, dtype=np.int64)
        val = np.zeros(tot, np.int64)

        def token(i):
            o = int(off[b, i])
            nxt = int(off[b, i + 1]) if i + 1 < ntok else tot
            n = 0 if o < 0 or o >= tot else min(nxt, tot) - o
            c = int(c1[b, i])
            return o, n, (c >> 9) & 3, c & 0xFF, int(tb[b, i])

        def put(o, j, kind, value, d):
            p = o + j
            if kind == 0:
                val[p] = value
            elif kind == 1 and d > 0:
                par[p] = max(o - d + j % d, 0)
            elif kind == 2:
                val[p] = rows[b, min(max(d + j, 0), M - 1)]

        queue = []
        for t in range(THREADS):  # a thread's tokens, in turn
            for i in range(t, ntok, THREADS):
                o, n, kind, value, d = token(i)
                if n > LONG:
                    queue.append(i)
                    continue
                for j in range(max(n, 0)):
                    put(o, j, kind, value, d)
        for w in range(THREADS // WARP):  # a warp's queued tokens
            for i in queue[w :: THREADS // WARP]:
                o, n, kind, value, d = token(i)
                for j in range(n):
                    put(o, j, kind, value, d)
        rounds = 0
        while True:
            rounds += 1
            nxt = par[par]
            if (nxt == par).all():
                break
            par = nxt
        stats.append((rounds, len(queue)))
        out[b, :tot] = val[par]
    return out


def _lanes():
    """(name, rows, tk, ta, tb, tp, out_cap) of each batch."""
    rng = np.random.default_rng(5)
    batches = []
    # a distance-1 run over the whole row: a literal, then matches of 258
    for name, width in (("run1", 1 << 14), ("run1_full", 1 << 16)):
        n_run = width // 258
        tk = np.ones((1, n_run + 2), np.int32)
        ta = np.full((1, n_run + 2), 258, np.int32)
        tb = np.ones((1, n_run + 2), np.int32)
        tk[0, 0], ta[0, 0], tb[0, 0] = 0, 65, 0
        ta[0, -1] = width - 1 - 258 * n_run  # the row's last bytes
        batches.append((name, np.zeros((1, 1), np.uint8), tk, ta, tb,
                        np.array([n_run + 2], np.int32), width))
    # a stored token as wide as the row, and stored tokens among others
    rows = rng.integers(0, 256, (2, 4200), dtype=np.uint8)
    tk = np.array([[2, 0, 0, 0], [0, 2, 1, 2]], np.int32)
    ta = np.array([[4096, 0, 0, 0], [7, 3000, 258, 0]], np.int32)
    tb = np.array([[40, 0, 0, 0], [0, 100, 2999, 9]], np.int32)
    batches.append(("stored", rows, tk, ta, tb, np.array([1, 4], np.int32), 4096))
    # a match before the row, an empty lane, tokens past the row
    tk = np.array([[0, 0, 1, 0, 1, 0, 0, 0], [0] * 8, [0, 1, 1, 0, 1, 1, 1, 1]],
                  np.int32)
    ta = np.array([[65, 66, 4, 67, 40, 0, 0, 0], [0] * 8,
                   [9, 258, 258, 3, 258, 258, 258, 9]], np.int32)
    tb = np.array([[0, 0, 5, 0, 80, 0, 0, 0], [0] * 8, [0, 1, 200, 0, 1, 7, 250, 1]],
                  np.int32)
    batches.append(("edges", np.zeros((3, 1), np.uint8), tk, ta, tb,
                    np.array([5, 0, 8], np.int32), 1024))
    return batches


def _check(rows, off, c1, tb, tp, total, out_cap, want):
    stats = []
    got = model_expand(rows, off, c1, tb, tp, total, out_cap, stats)
    plain = expand_fused3_plain(*(torch.from_numpy(np.asarray(x)) for x in
                                  (rows, off, c1, tb, tp, total)), out_cap)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, want)
    assert all(r <= out_cap.bit_length() + 1 for r, _ in stats)
    return stats


@pytest.mark.parametrize("seed,out_cap,max_dist,lit_bias", [
    (0, 2048, 256, 0.5),
    (2, 4096, 4, 0.15),  # overlapping runs, dist < len
])
def test_model_equals_plain_and_pallas_random(seed, out_cap, max_dist, lit_bias):
    rng = np.random.default_rng(seed)
    off, c1, tb, tp, total, refs = make_tokens(
        rng, out_cap, max_dist=max_dist, lit_bias=lit_bias, nlanes=2)
    want = np.asarray(j_expand3(off, c1, tb, tp, total, out_cap=out_cap,
                                interpret=True)).astype(np.uint8)
    args = [np.asarray(x) for x in (off, c1, tb, tp, total)]
    stats = _check(np.zeros((2, 1), np.uint8), *args, out_cap, want)
    assert sum(q for _, q in stats) > 0  # long matches went to the queue


@pytest.mark.parametrize("name", ["run1", "run1_full", "stored", "edges"])
def test_model_equals_plain_and_jax_edges(name):
    _, rows, tk, ta, tb, tp, out_cap = next(b for b in _lanes() if b[0] == name)
    # token arrays as wide as the decode path's (the JAX kernel needs it)
    tk, ta, tb = (np.pad(x, ((0, 0), (0, out_cap + 16 - x.shape[1]))) for x in (tk, ta, tb))
    off, c1, total = (x.numpy() for x in X._expand_inputs(
        torch.from_numpy(tk), torch.from_numpy(ta), torch.from_numpy(tp)))
    if name in ("stored", "run1_full"):
        # the JAX kernel takes no stored tokens; on a distance-1 run of 2^16
        # bytes it leaves the second half zero, its XLA route does not
        want, _ = j_expand_batch(jnp.asarray(rows), *map(jnp.asarray, (tk, ta, tb, tp)),
                                 out_cap=out_cap)
    else:
        want = j_expand3(*map(jnp.asarray, (off, c1, tb, tp, total)),
                         out_cap=out_cap, interpret=True)
    want = np.asarray(want).astype(np.uint8)
    stats = _check(rows, off, c1, tb, tp, total, out_cap, want)
    if name.startswith("run1"):
        assert want[0].tolist() == [65] * out_cap
        assert stats[0][0] >= out_cap.bit_length() - 9  # a chain as deep as the row
    elif name == "stored":
        assert want[0].tolist() == rows[0, 40 : 40 + 4096].tolist()
        assert stats[0][1] == 1 and stats[1][1] == 2
    else:
        assert want[0, :7].tolist() == [65, 66, 65, 65, 65, 65, 67]
        assert total[2] > out_cap and not want[1].any()
