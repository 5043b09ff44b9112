"""Each tpu_deflate_torch kernel's plain version (the CPU route of its
wrapper) against the JAX package's function on the same numpy inputs.
Every output is integer data, held to exact equality."""

from __future__ import annotations

import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.corpora import corpus  # noqa: E402
from tests.test_expand3 import make_tokens  # noqa: E402
from tpu_deflate.kernels.expand3 import expand_fused3 as j_expand3  # noqa: E402
from tpu_deflate.kernels.match2 import match_bitplane_batch as j_match  # noqa: E402
from tpu_deflate.kernels.monotone import mono_scatter_add_xla  # noqa: E402
from tpu_deflate.kernels.tokenize import (  # noqa: E402
    tokenize_static_batch as j_tok_fused,
)
from tpu_deflate.ops.decode import expand_batch as j_expand_batch  # noqa: E402
from tpu_deflate.ops.decode import tokenize as j_tokenize  # noqa: E402
from tpu_deflate.ops.encode import _match_extend_bitplane  # noqa: E402
from tpu_deflate_torch.kernels.expand3 import expand_fused3  # noqa: E402
from tpu_deflate_torch.lanes import bits_to_bytes  # noqa: E402
from tpu_deflate_torch.kernels.match2 import match_bitplane_batch  # noqa: E402
from tpu_deflate_torch.kernels.monotone import mono_scatter_add  # noqa: E402
from tpu_deflate_torch.kernels.tokenize import (  # noqa: E402
    ERR_BAD_CODE,
    ERR_DIST,
    ERR_DYNAMIC,
    ERR_INPUT,
    ERR_METHOD,
    ERR_OK,
    ERR_OVERFLOW,
    ERR_STORED,
    tokenize_static_batch,
)
from tpu_deflate_torch.ops.decode import chunk_pwin  # noqa: E402
from tpu_deflate_torch.spec import tables as T  # noqa: E402


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# match2: modes 0-7 as the lanes of one batch, n < N on every lane
# ---------------------------------------------------------------------------


def _match_lanes(N):
    data = np.zeros((8, N), np.uint8)
    ns = np.zeros(8, np.int32)
    for mode in range(8):
        raw = np.frombuffer(corpus(mode, N - 5 - 3 * mode), np.uint8)
        data[mode, : len(raw)] = raw
        data[mode, len(raw):] = 7  # bytes past n must never match
        ns[mode] = len(raw)
    return data, ns


@pytest.mark.parametrize("N", [1024, 4096])
@pytest.mark.parametrize("window,max_match", [(32, 5), (32, 10), (256, 5),
                                              (256, 10)])
def test_match_equals_pallas_interpret(N, window, max_match):
    data, ns = _match_lanes(N)
    dist, length = match_bitplane_batch(t(data), t(ns), window, max_match)
    jd, jl = j_match(jnp.asarray(data), jnp.asarray(ns), window, max_match,
                     interpret=True)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(length.numpy(), np.asarray(jl))


@pytest.mark.parametrize("N,window,max_match", [(1024, 32, 5),
                                                (4096, 256, 10)])
def test_match_equals_xla_bitplane(N, window, max_match):
    data, ns = _match_lanes(N)
    dist, length = match_bitplane_batch(t(data), t(ns), window, max_match)
    jd, jl = jax.vmap(
        lambda d, n: _match_extend_bitplane(d, n, window, max_match)
    )(jnp.asarray(data).astype(jnp.int32), jnp.asarray(ns))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(length.numpy(), np.asarray(jl))


# ---------------------------------------------------------------------------
# monotone scatter-add, with dead entries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,C", [(0, 2), (1, 3), (2, 1)])
def test_scatter_add_equals_xla(seed, C):
    rng = np.random.default_rng(seed)
    B, K, size = 3, 4096, 6000
    idx = np.cumsum(rng.integers(0, 4, (B, K)), axis=1).astype(np.int32)
    idx[:, -300:] = size + 5  # dead tail past the output
    idx[0, :10] = -1  # and dead entries before it
    vals = rng.integers(0, 1 << 16, (B, C, K)).astype(np.int32)
    vals[:, :, ::7] = 0
    got = mono_scatter_add(t(idx), t(vals), size)
    want = mono_scatter_add_xla(jnp.asarray(idx), jnp.asarray(vals), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# tokenize: static, stored, empty, truncated, corrupted, dynamic lanes
# ---------------------------------------------------------------------------

M = 4096


_bits_to_bytes = bits_to_bytes


def _static_block(tokens, final=1):
    """A static block of ("lit", byte) / ("match", length, dist) tokens."""
    f = [(final, 1), (1, 2)]

    def code(sym):
        return int(T.STATIC_LITLEN_CODES_REV[sym]), int(T.STATIC_LITLEN_LENGTHS[sym])

    for tok in tokens:
        if tok[0] == "lit":
            f.append(code(tok[1]))
        else:
            _, ln, d = tok
            s = int(T.LEN_TO_SYM[ln])
            f += [code(257 + s), (int(T.LEN_TO_EXTRA[ln]), int(T.LENGTH_EXTRA_BITS[s]))]
            ds = int(T.DIST_TO_SYM[d])
            f += [(int(T.STATIC_DIST_CODES_REV[ds]), 5),
                  (int(T.DIST_TO_EXTRA[d]), int(T.DIST_EXTRA_BITS[ds]))]
    f.append(code(256))
    return _bits_to_bytes(f)


def _zlib_raw(payload, level=9, strategy=zlib.Z_DEFAULT_STRATEGY):
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return co.compress(payload) + co.flush()


def _token_lanes():
    """(name, stream bytes, end bit) per lane; the rows are M bytes wide."""
    rng = np.random.default_rng(3)
    fixed = _zlib_raw(corpus(0, 2200), strategy=zlib.Z_FIXED)
    text = corpus(2, 3000)
    lanes = [
        ("static", fixed, None),
        ("static_text", _zlib_raw(text, strategy=zlib.Z_FIXED), None),
        ("static_runs", _zlib_raw(corpus(6, 2500), strategy=zlib.Z_FIXED), None),
        ("stored", _zlib_raw(bytes(rng.integers(0, 256, 900, dtype=np.uint8)), 0),
         None),
        # a non-final stored block, then a static one
        ("stored_then_static",
         b"\x00" + (5).to_bytes(2, "little") + (5 ^ 0xFFFF).to_bytes(2, "little")
         + b"hello" + fixed, None),
        ("empty", b"", 0),
        ("truncated", fixed, 8 * len(fixed) // 2),
        ("corrupted", bytes(b ^ 0x5A if i % 97 == 50 else b
                            for i, b in enumerate(fixed)), None),
        ("dynamic", _zlib_raw(text, 9), None),
        ("too_far", _static_block([("lit", 65), ("match", 5, 3)]), None),
        ("method3", b"\x07\x00", None),
        ("bad_stored", b"\x01\x05\x00\x00\x00hello", None),
        ("eob_only", _static_block([]), None),
    ]
    out = []
    for name, s, end in lanes:
        assert len(s) <= M, name
        out.append((name, s, 8 * len(s) if end is None else end))
    return out


def _rows(lanes):
    rows = np.zeros((len(lanes), M), np.uint8)
    for i, (_, s, _) in enumerate(lanes):
        rows[i, : len(s)] = np.frombuffer(s, np.uint8)
    ends = np.array([e for _, _, e in lanes], np.int32)
    return rows, ends


@pytest.mark.parametrize("tok_cap,pwin", [
    (M + 16, chunk_pwin(M)),  # the decode path's shape: one pass per lane
    (M + 16, 17 << 6),        # passes of 1088 bits: lanes span several
    (300, chunk_pwin(M)),     # a capacity that some lanes overflow
])
def test_tokenize_equals_xla_tokenize(tok_cap, pwin):
    lanes = _token_lanes()
    rows, ends = _rows(lanes)
    got = [x.numpy() for x in tokenize_static_batch(t(rows), t(ends), tok_cap, pwin)]
    tk, ta, tb, tp, tot, pos, err = got
    jtok = jax.jit(jax.vmap(lambda row, e: j_tokenize(
        row, 0, tok_cap=tok_cap, end_bit=e, pwin=pwin, stop_at_eob=True,
        static_only=True)))
    want = [np.asarray(x) for x in jtok(jnp.asarray(rows), jnp.asarray(ends))]
    jtk, jta, jtb, jtp, jtot, jpos, jerr = want
    for i, (name, _, _) in enumerate(lanes):
        assert err[i] == jerr[i], (name, err[i], jerr[i])
        if err[i] != ERR_OK:
            continue
        n = int(jtp[i])
        assert (tp[i], tot[i], pos[i]) == (n, jtot[i], jpos[i]), name
        for g, w in ((tk, jtk), (ta, jta), (tb, jtb)):
            np.testing.assert_array_equal(g[i, :n], w[i, :n], err_msg=name)
            assert not g[i, n:].any(), name
    codes = dict(zip([name for name, _, _ in lanes], err))
    if tok_cap > M:
        assert codes["static"] == codes["stored"] == ERR_OK
        assert codes["stored_then_static"] == codes["empty"] == ERR_OK
        assert codes["truncated"] in (ERR_BAD_CODE, ERR_INPUT)
        assert codes["dynamic"] == ERR_DYNAMIC
        assert codes["too_far"] == ERR_DIST
        assert codes["method3"] == ERR_METHOD
        assert codes["bad_stored"] == ERR_STORED
    else:
        assert codes["static_text"] == ERR_OVERFLOW


def test_tokenize_equals_pallas_fused():
    """Static and empty lanes against the fused Pallas tokenizer, which
    starts past the block header and takes no other lane."""
    lanes = [ln for ln in _token_lanes()
             if ln[0] in ("static", "static_text", "static_runs", "empty",
                          "too_far", "eob_only", "corrupted")]
    rows, ends = _rows(lanes)
    tk, ta, tb, tp, tot, pos, err = (
        x.numpy() for x in tokenize_static_batch(t(rows), t(ends), M + 16,
                                                 chunk_pwin(M)))
    tok, ntok, jtot, jpos, jerr = (np.asarray(x) for x in j_tok_fused(
        jnp.asarray(rows), jnp.asarray(ends), pw=64 * 512, interpret=True))
    for i, (name, _, end) in enumerate(lanes):
        assert err[i] == jerr[i], name
        if err[i] != ERR_OK:
            continue
        n = int(ntok[i])
        assert (tp[i], tot[i]) == (n, jtot[i]), name
        if end:  # the fused kernel reports an empty lane's end as bit 3
            assert pos[i] == jpos[i], name
        np.testing.assert_array_equal(tk[i, :n], (tok[i, :n] >> 26) & 3)
        np.testing.assert_array_equal(ta[i, :n], (tok[i, :n] >> 17) & 0x1FF)
        np.testing.assert_array_equal(tb[i, :n], tok[i, :n] & 0x1FFFF)


# ---------------------------------------------------------------------------
# expand: random token streams, overlap runs, stored tokens
# ---------------------------------------------------------------------------


def _expand_port(rows, off, c1, tb, tp, total, out_cap):
    args = [np.asarray(x) for x in (off, c1, tb, tp, total)]
    return expand_fused3(t(rows), *map(t, args), out_cap).numpy()


@pytest.mark.parametrize("seed,out_cap,max_dist,lit_bias", [
    (0, 2048, 256, 0.5),
    (1, 2048, 256, 0.5),
    (2, 4096, 4, 0.15),   # overlapping runs, dist < len
    (3, 65536, 256, 0.5),
])
def test_expand_equals_pallas_expand3(seed, out_cap, max_dist, lit_bias):
    rng = np.random.default_rng(seed)
    nl = 2 if out_cap > 4096 else 4
    off, c1, tb, tp, total, refs = make_tokens(
        rng, out_cap, max_dist=max_dist, lit_bias=lit_bias, nlanes=nl)
    rows = np.zeros((nl, 1), np.uint8)
    got = _expand_port(rows, off, c1, tb, tp, total, out_cap)
    want = np.asarray(j_expand3(off, c1, tb, tp, total, out_cap=out_cap,
                                interpret=True))
    np.testing.assert_array_equal(got, want)
    for b in range(nl):
        np.testing.assert_array_equal(got[b, : int(total[b])],
                                      refs[b, : int(total[b])])


def test_expand_stored_tokens_equal_expand_batch():
    """Stored tokens (longer than 511 bytes too) between literals and
    matches, against the JAX package's XLA expand route."""
    rng = np.random.default_rng(9)
    B, out_cap, K = 3, 4096, 64
    rows = rng.integers(0, 256, (B, 3000), dtype=np.uint8)
    tk = np.zeros((B, K), np.int32)
    ta = np.zeros((B, K), np.int32)
    tb = np.zeros((B, K), np.int32)
    streams = [
        [(2, 700, 5), (0, 65, 0), (1, 40, 3), (2, 0, 900), (2, 1200, 1000),
         (1, 258, 701)],
        [(0, 1, 0), (0, 2, 0), (1, 10, 2), (2, 30, 0)],
        [(2, 2900, 7)],
    ]
    tp = np.array([len(s) for s in streams], np.int32)
    for b, s in enumerate(streams):
        for k, (kind, a, d) in enumerate(s):
            tk[b, k], ta[b, k], tb[b, k] = kind, a, d
    n = np.where(np.arange(K) < tp[:, None], np.where(tk == 0, 1, ta), 0)
    off = np.cumsum(n, 1) - n
    c1 = ((tk & 3) << 9) | (ta & 0x1FF)
    got = _expand_port(rows, off, c1, tb, tp, n.sum(1), out_cap)
    want, total = j_expand_batch(jnp.asarray(rows), jnp.asarray(tk),
                                 jnp.asarray(ta), jnp.asarray(tb),
                                 jnp.asarray(tp), out_cap=out_cap)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(n.sum(1), np.asarray(total))
    assert got[0, :700].tobytes() == rows[0, 5:705].tobytes()
