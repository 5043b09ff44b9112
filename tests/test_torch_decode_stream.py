"""Single-stream decode and long rows of tpu_deflate_torch against the JAX
package, on the CPU: the resolve and expand2 wrappers (their plain
versions here), ``expand_batch``'s routing, the multi-block walk,
``inflate_device``, ``decompress`` with its error texts, and the indexed
container at 128 KiB chunks.  Everything is integers and bytes, so every
comparison is exact."""

from __future__ import annotations

import dataclasses
import gzip
import pathlib
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_deflate as tj  # noqa: E402
import tpu_deflate.kernels.expand2 as jexp2  # noqa: E402
import tpu_deflate.kernels.resolve as jres  # noqa: E402
import tpu_deflate.ops.decode as JD  # noqa: E402
import tpu_deflate.spec.tables as jtab  # noqa: E402
import tpu_deflate_torch as td  # noqa: E402
import tpu_deflate_torch.ops.decode as TD  # noqa: E402
from tests.corpora import corpus  # noqa: E402
from tpu_deflate.spec.bitstream import BitWriter  # noqa: E402
from tpu_deflate_torch.kernels.expand2 import expand_fused2  # noqa: E402
from tpu_deflate_torch.kernels.resolve import resolve_roots  # noqa: E402
from tpu_deflate_torch.kernels.tokenize import TK_MATCH, TK_STORED  # noqa: E402
from tpu_deflate_torch.ops.foreign import SEG  # noqa: E402

CORPUS = pathlib.Path(__file__).resolve().parent / "data" / "corpus.bin.gz"


def _bench(n: int, at: int = 0) -> bytes:
    return gzip.decompress(CORPUS.read_bytes())[at : at + n]


def _t(x, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


# ---------------------------------------------------------------------------
# resolve_roots
# ---------------------------------------------------------------------------


def _forest(case: str):
    rng = np.random.default_rng(17)
    B, N = 3, 5000
    idx = np.tile(np.arange(N), (B, 1))
    if case == "d1_run":  # one chain as deep as the row
        parent = np.maximum(idx - 1, 0)
    else:
        back = rng.integers(1, 600 if case == "near" else N, (B, N))
        parent = np.where(rng.random((B, N)) < 0.8, np.maximum(idx - back, 0), idx)
    parent[:, 0] = 0
    return parent.astype(np.int32), rng.integers(0, 256, (B, N)).astype(np.int32)


@pytest.mark.parametrize("case", ["near", "far", "d1_run"])
def test_resolve_roots_equal(case):
    parent, val = _forest(case)
    got = resolve_roots(_t(parent), _t(val))
    want = jres._resolve_xla(jnp.asarray(parent), jnp.asarray(val))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# expand_fused2: the cases of tests/test_fused_decode.py
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(1951)
EXPAND2_CASES = {
    "literals": ([0] * 100, list(range(1, 101)), [0] * 100),
    "d1_run_crossing": ([0] + [1] * 16, [65] + [258] * 16, [0] + [1] * 16),
    "d2_run_crossing": ([0, 0] + [1] * 16, [97, 98] + [258] * 16,
                        [0, 0] + [2] * 16),
    "match_at_boundary": (
        [0] * 2045 + [1, 1] + [0] * 5,
        [(i % 251) + 1 for i in range(2045)] + [10, 5, 1, 2, 3, 4, 5],
        [0] * 2045 + [7, 2000] + [0] * 5,
    ),
    "nested_overlaps": ([0, 0, 0, 1, 1, 1, 1], [1, 2, 3, 5, 7, 11, 258],
                        [0, 0, 0, 3, 5, 2, 13]),
    "wide_window": (
        [0] * 4000 + [1] * 8,
        [int(x) for x in _RNG.integers(1, 255, 4000)] + [258] * 8,
        [0] * 4000 + [3000, 3500, 2500, 4000, 3999, 2049, 2100, 2048],
    ),
}
E2_K, E2_CAP = 4224, 8192  # one token and row length, so one compile each


def _emulate(tks, tas, tbs) -> bytes:
    out = bytearray()
    for k, a, b in zip(tks, tas, tbs):
        if k == 0:
            out.append(a)
        else:
            for _ in range(a):
                out.append(out[-b])
    return bytes(out)


def _layout(tks, tas, tbs, K):
    tp = len(tks)
    tk, ta, tb = (np.zeros((1, K), np.int32) for _ in range(3))
    tk[0, :tp], ta[0, :tp], tb[0, :tp] = tks, tas, tbs
    n = np.where(np.arange(K) < tp, np.where(tk[0] == 0, 1, ta[0]), 0)
    off = (np.cumsum(n) - n).astype(np.int32)[None]
    c1 = ((tk & 3) << 9) | (ta & 0x1FF)
    return tk, ta, tb, off, c1, np.array([tp], np.int32), np.array([n.sum()], np.int32)


@pytest.mark.parametrize("name", list(EXPAND2_CASES))
def test_expand_fused2_equal(name):
    tks, tas, tbs = EXPAND2_CASES[name]
    tk, ta, tb, off, c1, tp, total = _layout(tks, tas, tbs, E2_K)
    got = expand_fused2(_t(off), _t(c1), _t(tb), _t(tp), _t(total), E2_CAP)
    assert got.dtype == torch.uint8 and got.shape == (1, E2_CAP)
    got = got.numpy()
    assert got[0, : total[0]].tobytes() == _emulate(tks, tas, tbs)
    assert not got[0, total[0] :].any()

    want = jexp2.expand_fused2(
        *(jnp.asarray(x) for x in (off, c1, tb, tp, total)), out_cap=E2_CAP,
        max_dist=32768 if name == "wide_window" else 2048, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.uint8))

    val, parent, in_range, _ = JD._expand_fields(
        jnp.zeros((8,), jnp.uint8), jnp.asarray(tk[0]), jnp.asarray(ta[0]),
        jnp.asarray(tb[0]), jnp.int32(tp[0]), jnp.bool_(False), E2_CAP)
    root = jres._resolve_xla(parent, val)
    np.testing.assert_array_equal(
        got[0], np.asarray(jnp.where(in_range, root, 0)).astype(np.uint8))


# ---------------------------------------------------------------------------
# expand_batch's routing
# ---------------------------------------------------------------------------


def _raw(data: bytes, level: int = 6, strategy=zlib.Z_DEFAULT_STRATEGY,
         **kw) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy, **kw)
    return co.compress(data) + co.flush()


def _stored(data: bytes, final: bool = False) -> bytes:
    n = len(data)
    return (bytes([int(final)]) + n.to_bytes(2, "little")
            + (n ^ 0xFFFF).to_bytes(2, "little") + data)


def _row(stream: bytes, M: int):
    row = np.zeros(M, np.uint8)
    row[: len(stream)] = np.frombuffer(stream, np.uint8)
    return row


@pytest.mark.parametrize("case,out_cap,with_stored", [
    ("fused3", 4096, True),
    ("fused2", 1 << 17, False),
    ("resolve_stored", 1 << 17, True),
    ("resolve_odd_length", (1 << 16) + 3000, False),
])
def test_expand_batch_equal(case, out_cap, with_stored):
    n = min(out_cap, 70000) - 500
    texts = [_bench(n), _bench(n, 1 << 20)]
    if with_stored:
        texts[1] = corpus(3, 300) + texts[1][:-300]
        streams = [_raw(texts[0], 9), _stored(texts[1][:300]) + _raw(
            texts[1][300:], 9, zdict=texts[1][:300])]
    else:
        streams = [_raw(t, 9) for t in texts]
    M, tok_cap = 1 << 15, 1 << 15
    rows = np.stack([_row(s, M) for s in streams])
    toks = [TD.tokenize(_t(r, torch.uint8), 0, tok_cap) for r in rows]
    assert all(t[6] == 0 for t in toks)
    tk, ta, tb = (torch.stack([t[i] for t in toks]) for i in range(3))
    tp = torch.tensor([t[3] for t in toks], dtype=torch.int32)
    assert bool((tk[1, : tp[1]] == TK_STORED).any()) == with_stored

    out, total = TD.expand_batch(_t(rows, torch.uint8), tk, ta, tb, tp, out_cap)
    jout, jtotal = JD.expand_batch(
        jnp.asarray(rows), *(jnp.asarray(x.numpy()) for x in (tk, ta, tb, tp)),
        out_cap=out_cap)
    assert out.dtype == torch.uint8 and out.shape == (2, out_cap)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
    for i, text in enumerate(texts):
        assert out[i, : total[i]].numpy().tobytes() == text


# ---------------------------------------------------------------------------
# The multi-block walk against tokenize(stop_at_eob=False)
# ---------------------------------------------------------------------------

WALK_M, WALK_TOK, WALK_PWIN = 1 << 17, (1 << 17) + 16, 1 << 15


def _mix() -> bytes:
    """Text, random bytes and text: dynamic and stored blocks."""
    return corpus(2, 30000) + corpus(3, 40000) + _bench(30000)


def _flushed() -> bytes:
    """Blocks cut by flushes (each leaves an empty stored block), the later
    ones with matches into the earlier ones' output."""
    a, b = _bench(20000), corpus(1, 9000)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    return (co.compress(a) + co.flush(zlib.Z_SYNC_FLUSH) + co.compress(b)
            + co.flush(zlib.Z_SYNC_FLUSH) + co.compress(a[5000:15000] + b)
            + co.flush(zlib.Z_FULL_FLUSH) + co.compress(a) + co.flush())


def _far() -> bytes:
    """A random block repeated 24 KiB later: distances above 2048."""
    block = corpus(3, 4000)
    return _raw(block + _bench(24000) + block + corpus(2, 3000) + block, 9)


WALKS = {
    # name: (stream, start_bit, end_bit, tok_cap, flags)
    "level0": (lambda: _raw(_mix(), 0), 0, None, WALK_TOK, {}),
    "level1": (lambda: _raw(_mix(), 1), 0, None, WALK_TOK, {}),
    "level6": (lambda: _raw(_mix(), 6), 0, None, WALK_TOK, {}),
    "level9": (lambda: _raw(_mix(), 9), 0, None, WALK_TOK, {}),
    "fixed": (lambda: _raw(_mix(), 9, zlib.Z_FIXED), 0, None, WALK_TOK, {}),
    "flushed": (_flushed, 0, None, WALK_TOK, {}),
    "far_distances": (_far, 0, None, WALK_TOK, {}),
    "zlib_wrapper": (lambda: zlib.compress(_mix(), 6), 16, None, WALK_TOK, {}),
    "stored_then_dynamic_reaching_back": (
        lambda: _stored(corpus(3, 700)) + _raw(corpus(2, 20000), 9,
                                               zdict=corpus(3, 700)),
        0, None, WALK_TOK, {}),
    "distance_before_start": (
        lambda: _raw(corpus(2, 20000), 9, zdict=corpus(2, 700)), 0, None,
        WALK_TOK, {}),
    "distance_before_start_second_block": (
        lambda: _stored(b"ab") + _raw(corpus(2, 9000), 9,
                                      zdict=corpus(2, 9000)[:500]),
        0, None, WALK_TOK, {}),
    "cut_in_a_block": (lambda: _raw(_mix(), 6)[:9000], 0, 72000, WALK_TOK, {}),
    "cut_at_a_block_edge": (
        lambda: _stored(corpus(3, 900)), 0, 8 * 905, WALK_TOK, {}),
    "reserved_type_after_a_block": (
        lambda: _stored(corpus(3, 900)) + b"\x07", 0, None, WALK_TOK, {}),
    "empty": (lambda: b"", 0, 0, WALK_TOK, {}),
    "token_overflow": (lambda: _raw(_mix(), 6), 0, None, 5000, {}),
    "static_only_fixed": (
        lambda: _raw(_mix(), 9, zlib.Z_FIXED), 0, None, WALK_TOK,
        {"static_only": True}),
    "static_only_dynamic": (
        lambda: _stored(corpus(3, 900)) + _raw(_mix(), 6), 0, None, WALK_TOK,
        {"static_only": True}),
    "one_block_dynamic": (lambda: _flushed(), 0, None, WALK_TOK,
                          {"one_block": True}),
    "one_block_stored": (lambda: _raw(_mix(), 0), 0, None, WALK_TOK,
                         {"one_block": True}),
    "one_block_fixed": (
        lambda: _raw(_bench(3000), 9, zlib.Z_FIXED) + _raw(_bench(3000), 9),
        0, None, WALK_TOK, {"one_block": True}),
}


@pytest.mark.parametrize("name", list(WALKS))
def test_walk_equal(name):
    make, start_bit, end_bit, tok_cap, flags = WALKS[name]
    row = _row(make(), WALK_M)
    got = TD.tokenize(_t(row, torch.uint8), start_bit, tok_cap,
                      end_bit=end_bit, pwin=WALK_PWIN, **flags)
    want = JD.tokenize(jnp.asarray(row), start_bit, tok_cap=tok_cap,
                       end_bit=end_bit, pwin=WALK_PWIN, **flags)
    tp = int(want[3])
    assert got[3:] == tuple(int(x) for x in want[3:]), (got[3:], want[3:])
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32 and g.shape == (tok_cap,)
        np.testing.assert_array_equal(g.numpy()[:tp], np.asarray(w)[:tp])


def test_walk_cases_cover_what_they_name(monkeypatch):
    """The inputs above hold what their names say."""
    headers = []
    parse = TD.dyn_header_params_batch
    monkeypatch.setattr(TD, "dyn_header_params_batch",
                        lambda *a: headers.append(a) or parse(*a))

    def blocks(stream):
        del headers[:]
        row = _row(stream, WALK_M)
        tk, _ta, tb, tp, _tot, _pos, err = TD.tokenize(
            _t(row, torch.uint8), 0, WALK_TOK, pwin=WALK_PWIN)
        assert err == 0
        return tk[:tp], tb[:tp], len(headers)

    tk, tb, dynamic = blocks(_raw(_mix(), 6))
    assert dynamic >= 2 and bool((tk == TK_MATCH).any())
    assert bool((tk == TK_STORED).any())  # the random part, between them
    tk, tb, dynamic = blocks(_raw(_mix(), 0))
    assert dynamic == 0 and int((tk == TK_STORED).sum()) >= 2
    tk, tb, dynamic = blocks(_far())
    assert int(tb[tk == TK_MATCH].max()) > 2048
    tk, tb, dynamic = blocks(_flushed())
    assert dynamic == 4
    assert int((tk == TK_STORED).sum()) == 3  # the flushes' empty blocks
    assert int(tb[tk == TK_MATCH].max()) > 20000  # into the first block


# ---------------------------------------------------------------------------
# inflate_device and decompress
# ---------------------------------------------------------------------------


def _long_output():
    """(stored block's bytes, body): past SEG + 256 bytes of output from
    little input, a long run of zeros, text, and the run again."""
    return corpus(3, 600), bytes(400000) + _bench(60000) + bytes(150000)


INFLATES = {
    "level6": (lambda: _raw(_mix(), 6), None, {}),
    "level0": (lambda: _raw(_mix(), 0), None, {}),
    "fixed_static_only": (lambda: _raw(_mix(), 9, zlib.Z_FIXED), None,
                          {"static_only": True}),
    "one_block": (lambda: _raw(_mix(), 6), None, {"one_block": True}),
    "doubling_retry": (lambda: _raw(corpus(2, 15000), 6), 1 << 12, {}),
}


@pytest.mark.parametrize("name", list(INFLATES))
def test_inflate_device_equal(name):
    make, out_cap, flags = INFLATES[name]
    stream = make()
    out, total, end_bit = TD.inflate_device(stream, out_cap=out_cap,
                                            device="cpu", **flags)
    jout, jtotal, jend = JD.inflate_device(stream, out_cap=out_cap, **flags)
    assert (total, end_bit) == (jtotal, jend)
    assert out.dtype == np.uint8
    assert out[:total].tobytes() == jout[:total].tobytes()
    if not flags.get("one_block"):
        assert out[:total].tobytes() == zlib.decompressobj(-15).decompress(stream)


@pytest.mark.parametrize("with_stored", [False, True])
def test_inflate_device_segments_equal(with_stored):
    """Output past SEG + 256 expands in segments; with a stored token in
    the first segment that one takes the resolve route."""
    head, body = _long_output()
    if with_stored:
        stream = _stored(head) + _raw(body, 6, zdict=head)
        want = head + body
    else:
        stream, want = _raw(body, 6), body
    assert len(want) > SEG + 256
    out, total, end_bit = TD.inflate_device(stream, out_cap=1 << 20,
                                            device="cpu")
    jout, jtotal, jend = JD.inflate_device(stream, out_cap=1 << 20)
    assert (total, end_bit) == (jtotal, jend)
    assert out[:total].tobytes() == jout[:total].tobytes() == want


def _wrap(body: bytes, payload: bytes = b"") -> bytes:
    return b"\x78\x9c" + body + zlib.adler32(payload).to_bytes(4, "big")


def _bits(*fields) -> bytes:
    bw = BitWriter()
    for value, nbits in fields:
        bw.write_bits(value, nbits)
    return bw.getvalue()


def _decompress_cases():
    small = zlib.compress(corpus(0, 400))
    bad_check, bad_adler = bytearray(zlib.compress(b"data")), bytearray(small)
    bad_check[1] ^= 0x01
    bad_adler[-1] ^= 0xFF
    cases = {
        "level0": zlib.compress(corpus(1, 900), 0),
        "level1": zlib.compress(corpus(1, 900), 1),
        "level6": zlib.compress(corpus(2, 900), 6),
        "level9": zlib.compress(corpus(6, 900), 9),
        "empty": zlib.compress(b""),
        "reserved_btype": _wrap(_bits((1, 1), (3, 2))),
        "stored_len_nlen_mismatch": _wrap(
            _bits((1, 1), (0, 2)) + b"\x05\x00\x00\x00" + b"xxxxx"),
        # static block: length 3 at distance 5 with no output yet
        "distance_before_start": _wrap(
            _bits((1, 1), (1, 2), (int(jtab.STATIC_LITLEN_CODES_REV[257]), 7),
                  (0b00100, 5), (0, 1))),
        "bad_header_check": bytes(bad_check),
        "adler_mismatch": bytes(bad_adler),
        "garbage": b"\xde\xad\xbe\xef" * 100,
        "too_short": small[:5],
    }
    for cut in (8, len(small) // 2, len(small) - 5):
        cases[f"truncated_{cut}"] = small[:cut]
    return cases


DECOMPRESS = _decompress_cases()


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # the comparison is of type and text
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", list(DECOMPRESS))
def test_decompress_equal(name):
    """Bytes, or the error's type and text, equal to the JAX package's."""
    stream = DECOMPRESS[name]
    got = _outcome(lambda: td.decompress(stream, device="cpu"))
    want = _outcome(lambda: tj.decompress(stream))
    assert got == want
    if name.startswith("level"):
        assert got == zlib.decompress(stream)
    elif name != "empty":
        assert got[0] == "DeflateError"


@pytest.mark.parametrize("fields,ok", [
    ({"dynamic": False}, False),
    ({"low_lut": True, "compress": False, "dynamic": False, "match10": False},
     False),
    ({"one_block": True}, True),
    ({"decompress": False, "compress": True}, False),
])
def test_decompress_config_flags_equal(fields, ok):
    stream = zlib.compress(corpus(2, 900), 6)
    got = _outcome(lambda: td.decompress(stream, td.DeflateConfig(**fields),
                                         device="cpu"))
    want = _outcome(lambda: tj.decompress(stream, tj.DeflateConfig(**fields)))
    assert got == want
    assert isinstance(got, bytes) == ok


def test_decompress_multi_block_stream():
    """A zlib -6 stream of several dynamic blocks, and the port's own
    static stream read without its index."""
    data = _bench(300000)
    stream = zlib.compress(data, 6)
    assert td.decompress(stream, device="cpu") == data
    own = td.compress(data[:40000], td.DeflateConfig(chunk_size=1 << 13),
                      device="cpu")
    cfg = td.DeflateConfig(dynamic=False)
    assert td.decompress(own, cfg, device="cpu") == data[:40000]
    assert tj.decompress(own, tj.DeflateConfig(dynamic=False)) == data[:40000]


# ---------------------------------------------------------------------------
# The indexed container at 128 KiB chunks
# ---------------------------------------------------------------------------

LONG = 1 << 17


@pytest.mark.parametrize("dynamic", [False, True])
def test_long_rows_equal(dynamic):
    """Three lanes of 128 KiB, the middle one random (stored): the stream
    and the decode equal the JAX package's."""
    data = _bench(LONG) + corpus(3, LONG) + _bench(LONG - 999, 1 << 20)
    fields = dataclasses.asdict(tj.DeflateConfig(chunk_size=LONG,
                                                 dynamic_encode=dynamic))
    jcfg, tcfg = tj.DeflateConfig(**fields), td.DeflateConfig(**fields)
    stream, index = td.compress_indexed(data, tcfg, device="cpu")
    jstream, jindex = tj.compress_indexed(data, jcfg)
    assert stream == jstream
    np.testing.assert_array_equal(index, jindex)
    assert zlib.decompress(stream) == data
    assert td.decompress_indexed(stream, index, tcfg, device="cpu") == data
    assert tj.decompress_indexed(stream, index, jcfg) == data
