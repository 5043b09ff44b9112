"""The device-paced decode of one stream in tpu_deflate_torch against the
JAX package, on the CPU: the two chases of ``kernels.chase1``, the
tile-parallel tokenizer ``tokenize_dyn_hier`` against the JAX
``tokenize_dyn_batch(hier=True, tier=2)`` in interpret mode, the header's
code lengths at the foreign loop's window, and the whole loop
``inflate_foreign_device`` against zlib and the JAX general pipeline (the
JAX device-paced loop runs only on a TPU).  Everything is integers and
bytes, so every comparison is exact."""

from __future__ import annotations

import gzip
import pathlib
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_deflate.kernels.chase1 as jchase  # noqa: E402
import tpu_deflate.ops.decode as JD  # noqa: E402
import tpu_deflate.spec.tables as jtab  # noqa: E402
import tpu_deflate_torch.ops.decode as TD  # noqa: E402
import tpu_deflate_torch.ops.foreign as TF  # noqa: E402
from tests.corpora import corpus  # noqa: E402
from tpu_deflate.kernels.tokenize_dyn import tokenize_dyn_batch as j_tok_dyn  # noqa: E402
from tpu_deflate_torch.kernels.chase1 import ent_from_phi, visited_from_adv  # noqa: E402
from tpu_deflate_torch.kernels.tokenize import (  # noqa: E402
    ERR_BAD_CODE,
    ERR_DIST,
    ERR_INPUT,
    ERR_OK,
)
from tpu_deflate_torch.kernels.tokenize_dyn import (  # noqa: E402
    TAB_OUTBASE,
    hier_shape,
    tokenize_dyn_hier,
)
from tpu_deflate_torch.ops.header import (  # noqa: E402
    canon_params,
    chase_reach,
    decode_cl_lengths,
)
from tpu_deflate_torch.ref.inflate import DeflateError  # noqa: E402

CORPUS = pathlib.Path(__file__).resolve().parent / "data" / "corpus.bin.gz"


def _bench(n: int, at: int = 0) -> bytes:
    return gzip.decompress(CORPUS.read_bytes())[at : at + n]


def _raw(data: bytes, level: int = 6, strategy=zlib.Z_DEFAULT_STRATEGY,
         **kw) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy, **kw)
    return co.compress(data) + co.flush()


def _stored(data: bytes, final: bool = False) -> bytes:
    n = len(data)
    return (bytes([int(final)]) + n.to_bytes(2, "little")
            + (n ^ 0xFFFF).to_bytes(2, "little") + data)


def _t(x, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _two_bit_literals() -> bytes:
    """A two-symbol alphabet: zlib gives its literals 2-bit codes."""
    rng = np.random.default_rng(7)
    return bytes(b"ab"[i] for i in rng.integers(0, 2, 3072))


# ---------------------------------------------------------------------------
# visited_from_adv
# ---------------------------------------------------------------------------


def _header_chase() -> tuple[np.ndarray, np.ndarray]:
    """(adv, term) of the code-length region of a real zlib -9 header, as
    the foreign loop's parse hands them to its reach function."""
    stream = _raw(_bench(20000), 9)
    host = np.pad(np.frombuffer(stream, np.uint8), (0, 4096))
    hclen = TF._peek(host, 13, 4) + 4
    cl = np.zeros(19, np.int64)
    for j in range(hclen):
        cl[jtab.CODE_LENGTH_ORDER[j]] = TF._peek(host, 17 + 3 * j, 3)
    seen = []
    lim, rd, sym, _ = canon_params(torch.from_numpy(cl)[None], 19)
    decode_cl_lengths(
        _t(host[None], torch.int64), torch.tensor([17 + 3 * hclen]),
        torch.tensor([TF._peek(host, 3, 5) + 258 + TF._peek(host, 8, 5)]),
        lim, rd, sym, win=TF.CLW,
        reach_fn=lambda a, t: seen.append((a, t)) or chase_reach(a, t))
    adv, term = seen[0]
    return adv[0].numpy(), term[0].numpy()


def _chase_case(name: str):
    T = 128
    P = 64 * T
    if name == "zlib9_header":
        adv, term = _header_chase()
        return adv, term, 0
    rng = np.random.default_rng(int(name[-1]))
    adv = rng.integers(1, 15, P)
    term = rng.random(P) < 0.002
    return adv, term, 5 if name.startswith("p0") else 0


@pytest.mark.parametrize("name", ["random0", "random1", "random2", "p0_5_random3",
                                  "zlib9_header"])
def test_visited_from_adv_equal(name):
    adv, term, p0 = _chase_case(name)
    T = len(adv) // 64
    advT = adv.reshape(T, 64).T.astype(np.int32)
    termT = term.reshape(T, 64).T.astype(np.int32)
    got = visited_from_adv(_t(advT), _t(termT), torch.tensor(p0, dtype=torch.int32))
    want = jchase.visited_from_adv(jnp.asarray(advT), jnp.asarray(termT),
                                   jnp.int32(p0), interpret=True)
    assert got.dtype == torch.int32 and got.shape == (64, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the orbit from p0 is chase_reach's from 0 on the positions after p0
    reach = chase_reach(torch.from_numpy(adv[p0:])[None],
                        torch.from_numpy(term[p0:])[None])[0].numpy()
    flat = got.numpy().T.reshape(-1)
    assert not flat[:p0].any()
    np.testing.assert_array_equal(flat[p0:] != 0, reach)
    assert flat.sum() > (100 if name == "zlib9_header" else 1)


# ---------------------------------------------------------------------------
# ent_from_phi
# ---------------------------------------------------------------------------


def _maps(T: int, seed: int) -> np.ndarray:
    """Packed transfer maps int32[1, 16, T] built as K1d builds them, from
    random jumps of 1..47 bits and terminators (STOP entries)."""
    rng = np.random.default_rng(seed)
    P = 64 * T
    adv = rng.integers(1, 48, P)
    term = rng.random(P) < 0.001
    m0 = np.where(term, 255, (np.arange(P) % 64) + adv).reshape(T, 64)
    m = np.tile(np.arange(64), (T, 1))
    for _ in range(64):
        m = np.where(m < 64, np.take_along_axis(m0, np.clip(m, 0, 63), 1), m)
    phi = np.where(m >= 128, 191, m - 64).T  # [64, T]
    packed = phi[0::4] | (phi[1::4] << 8) | (phi[2::4] << 16) | (phi[3::4] << 24)
    assert (phi == 191).any()
    return packed.astype(np.uint32).view(np.int32)[None]


@pytest.mark.parametrize("T,p0", [(256, 0), (256, 5), (8192, 0), (8192, 5)])
def test_ent_from_phi_equal(T, p0):
    phiP = _maps(T, T + p0)
    got = ent_from_phi(_t(phiP), torch.tensor(p0, dtype=torch.int32))
    want = jchase.ent_from_phi(jnp.asarray(phiP), jnp.int32(p0), interpret=True)
    assert got.dtype == torch.int32 and got.shape == (1, 1, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ent = got.numpy()[0, 0]
    assert ent[0] == p0 and (ent >= 0).sum() > 1


# ---------------------------------------------------------------------------
# tokenize_dyn_hier: one shape for every case (one JAX compile)
# ---------------------------------------------------------------------------

HIER_PW = 1 << 15
HIER_M = HIER_PW // 8


def _hier_case(name: str):
    """(rows uint8[1, HIER_M], end_bits, tab, starts) of one block re-based
    at its first symbol's byte, as the foreign loop hands it over."""
    out_base, cut, flip = 0, None, None
    if name == "dynamic_level9":
        stream = _raw(_bench(3000), 9)
    elif name == "static_fixed":
        stream = _raw(_bench(3000), 9, zlib.Z_FIXED)
    elif name == "two_bit_literals":
        stream = _raw(_two_bit_literals(), 9)
    elif name in ("reaches_before_block", "distance_before_start"):
        head = corpus(2, 700)
        stream = _raw(corpus(2, 3000), 9, zdict=head)
        out_base = len(head) if name == "reaches_before_block" else 0
    elif name == "corrupt_byte":
        stream = _raw(_bench(3000), 9)
        flip = len(stream) // 2 + 1
    elif name == "cut_short":
        stream = _raw(_bench(3000), 9)
        cut = 8 * (len(stream) // 2)
    else:  # runs_past_the_window: a block longer than the window
        stream = _raw(_bench(30000), 9)
    s = np.frombuffer(stream, np.uint8).copy()
    if flip is not None:
        s[flip] ^= 0x5A
    rows = np.zeros((1, len(s) + HIER_M), np.uint8)
    rows[0, : len(s)] = s
    # the port's header parse (held against the JAX package's in
    # test_torch_dynamic.py) gives the tables both tokenizers read
    prep = TD.dyn_header_params_batch(_t(rows, torch.uint8),
                                      torch.tensor([8 * len(s)], dtype=torch.int32))
    start = int(prep["start"][0])
    tab = prep["tab"].numpy().copy()
    tab[0, TAB_OUTBASE] = out_base
    base2 = start >> 3
    win = rows[:, base2 : base2 + HIER_M].copy()
    end = (cut if cut is not None else 8 * len(s)) - 8 * base2
    return (win, np.asarray([end], np.int32), tab.astype(np.int32),
            np.asarray([start & 7], np.int32), int(prep["min_len"][0]))


HIER_CASES = {
    # name: (err, an extra check)
    "dynamic_level9": ERR_OK,
    "static_fixed": ERR_OK,
    "two_bit_literals": ERR_OK,
    "reaches_before_block": ERR_OK,
    "distance_before_start": ERR_DIST,
    "corrupt_byte": None,
    "cut_short": ERR_BAD_CODE,
    "runs_past_the_window": ERR_INPUT,
}


@pytest.mark.parametrize("name", list(HIER_CASES))
def test_tokenize_dyn_hier_equal(name):
    rows, ends, tab, starts, min_len = _hier_case(name)
    assert min_len >= 2 and (min_len == 2) == (name == "two_bit_literals")
    got = tokenize_dyn_hier(_t(rows, torch.uint8), _t(ends), _t(tab), _t(starts),
                            HIER_PW)
    tok, ntok, out_total, end_pos, err = (np.asarray(x) for x in j_tok_dyn(
        jnp.asarray(rows), jnp.asarray(ends), jnp.asarray(tab),
        jnp.asarray(starts), pw=HIER_PW, interpret=True, hier=True, tier=2))
    n = int(ntok[0])
    assert [int(x[0]) for x in got[3:]] == [n, int(out_total[0]), int(end_pos[0]),
                                           int(err[0])]
    tokcap = hier_shape(HIER_PW)[2]
    assert tok.shape == (1, tokcap)
    for g in got[:3]:
        assert g.dtype == torch.int32 and g.shape == (1, tokcap)
    t = tok[0, :n]
    np.testing.assert_array_equal(got[0][0, :n].numpy(), (t >> 26) & 3)
    np.testing.assert_array_equal(got[1][0, :n].numpy(), (t >> 17) & 0x1FF)
    np.testing.assert_array_equal(got[2][0, :n].numpy(), t & 0x1FFFF)
    if HIER_CASES[name] is not None:
        assert int(err[0]) == HIER_CASES[name]
    else:
        assert int(err[0]) != ERR_OK
    assert n > 100


# ---------------------------------------------------------------------------
# the code lengths at the foreign loop's window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["level9", "level1", "two_bit_literals"])
def test_decode_cl_lengths_foreign_window_equal(name):
    data = {"level9": _bench(20000), "level1": corpus(1, 20000),
            "two_bit_literals": _two_bit_literals()}[name]
    stream = _raw(data, 1 if name == "level1" else 9)
    host = np.pad(np.frombuffer(stream, np.uint8), (0, 4096))
    hlit = TF._peek(host, 3, 5) + 257
    hdist = TF._peek(host, 8, 5) + 1
    hclen = TF._peek(host, 13, 4) + 4
    cl = np.zeros(19, np.int64)
    for j in range(hclen):
        cl[jtab.CODE_LENGTH_ORDER[j]] = TF._peek(host, 17 + 3 * j, 3)
    pos0 = 17 + 3 * hclen
    lim, rd, sym, _ = canon_params(torch.from_numpy(cl)[None], 19)
    got = decode_cl_lengths(_t(host[None], torch.int64), torch.tensor([pos0]),
                            torch.tensor([hlit + hdist]), lim, rd, sym,
                            win=TF.CLW, reach_fn=TF.cl_reach)
    jlim, jrd, jmeta, _ = JD._canon_params_jax(jnp.asarray(cl, jnp.int32), 19,
                                               lambda s, xp=np: s)
    want = JD._decode_cl_lengths(jnp.asarray(host), jnp.int32(pos0),
                                 jnp.int32(hlit + hdist), jlim, jrd, jmeta,
                                 win=TF.CLW)
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    assert int(got[1][0]) == int(want[1]) > 0
    assert bool(got[2][0]) and bool(want[2])


# ---------------------------------------------------------------------------
# the whole loop
# ---------------------------------------------------------------------------


def _flushed() -> bytes:
    """Blocks cut by flushes, the later ones with matches into the earlier
    ones' output."""
    a, b = _bench(30000), _bench(9000, at=200000)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    return (co.compress(a) + co.flush(zlib.Z_SYNC_FLUSH) + co.compress(b)
            + co.flush(zlib.Z_SYNC_FLUSH) + co.compress(a[5000:25000] + b)
            + co.flush(zlib.Z_FULL_FLUSH) + co.compress(a) + co.flush())


# compressed sizes between 16 and 32 KiB, so that the JAX general pipeline
# compiles once for all but the long output
VALID = {
    "level0": lambda: _raw(_bench(25000), 0),
    "level1": lambda: _raw(_bench(60000), 1),
    "level6": lambda: _raw(_bench(90000), 6),
    "level9": lambda: _raw(_bench(90000, at=100000), 9),
    "fixed": lambda: _raw(_bench(90000), 9, zlib.Z_FIXED),
    "stored_then_dynamic": lambda: _stored(corpus(3, 700)) + _raw(
        _bench(80000), 9, zdict=corpus(3, 700)),
    "across_blocks": _flushed,
    "long_output": lambda: _raw(bytes(400000) + _bench(60000) + bytes(150000), 6),
}


@pytest.mark.parametrize("name", list(VALID))
def test_inflate_foreign_device_equal(name):
    stream = VALID[name]()
    assert 16384 < len(stream) <= 32768
    got = TF.inflate_foreign_device(stream, device="cpu")
    assert got is not None
    out, total, end_bit = got
    jout, jtotal, jend = JD.inflate_device(stream)
    assert (total, end_bit) == (jtotal, jend)
    assert out.dtype == np.uint8
    assert out[:total].tobytes() == jout[:jtotal].tobytes()
    assert out[:total].tobytes() == zlib.decompressobj(-15).decompress(stream)
    if name == "long_output":
        assert total > TF.SEG + 256


def _blocks(stream: bytes) -> list[int]:
    """Block types of a valid raw stream, by the foreign loop's walk."""
    types = []
    walk = TF._huffman_block

    def spy(arr, host, pos, *a):
        types.append(TF._peek(host, pos + 1, 2))
        return walk(arr, host, pos, *a)

    TF._huffman_block = spy
    try:
        TF.inflate_foreign_device(stream, device="cpu")
    finally:
        TF._huffman_block = walk
    return types


def test_valid_streams_hold_what_they_name():
    assert _blocks(VALID["level0"]()) == []
    assert set(_blocks(VALID["level6"]())) == {2}
    assert set(_blocks(VALID["fixed"]())) == {1}
    assert len(_blocks(VALID["across_blocks"]())) >= 4
    assert len(_blocks(VALID["stored_then_dynamic"]())) == 1


def test_one_bit_literal_code_falls_back():
    # the block falls back to the lane tokenizer, within the walk
    stream = _raw(b"a" * 6000 + corpus(3, 40), 9, zlib.Z_HUFFMAN_ONLY)
    out, total, end = TF.inflate_foreign_device(stream, device="cpu")
    assert out[:total].tobytes() == b"a" * 6000 + corpus(3, 40)
    # as the general pipeline decodes it
    g_out, g_total, g_end = TD._inflate_general(stream, device="cpu")
    assert (g_out[:g_total].tobytes(), g_end) == (out[:total].tobytes(), end)


def test_the_walk_goes_on_after_a_one_bit_block():
    """A block with a 1-bit literal code, a stored block, then a block
    of longer codes whose matches reach back into the first's output."""
    first = corpus(2, 2000) + bytes(6000)
    then = corpus(2, 2000) + corpus(3, 2000)
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 8, zlib.Z_HUFFMAN_ONLY)
    stream = co.compress(first) + co.flush(zlib.Z_FULL_FLUSH) + _raw(then, zdict=first)
    lanes = []
    lane_block = TF._lane_block
    TF._lane_block = lambda *a: lanes.append(a[4]) or lane_block(*a)
    try:
        out, total, end = TF.inflate_foreign_device(stream + b"tail", device="cpu")
    finally:
        TF._lane_block = lane_block
    assert out[:total].tobytes() == first + then and end == 8 * len(stream)
    assert lanes == [0]  # the first block alone, from the stream's first token


def test_a_walk_of_more_tokens_than_its_buffers():
    """1-bit codes, a token a bit: past the buffers' token per 3 bits of
    input, which the walk doubles and goes on."""
    data = bytes(200000) + corpus(2, 3000)
    sizes = []
    lane_block = TF._lane_block
    TF._lane_block = lambda *a: sizes.append(a[5][0].shape[0]) or lane_block(*a)
    try:
        out, total, _ = TF.inflate_foreign_device(_raw(data, 9, zlib.Z_HUFFMAN_ONLY),
                                                  device="cpu")
    finally:
        TF._lane_block = lane_block
    assert out[:total].tobytes() == data
    assert len(sizes) >= 12 and sizes[-1] == 2 * sizes[0]


def _bits(*fields) -> bytes:
    acc = n = 0
    for value, nbits in fields:
        acc |= value << n
        n += nbits
    return acc.to_bytes((n + 7) // 8 + 2, "little")


def _bad_header() -> bytes:
    """A dynamic header whose code-length code is oversubscribed."""
    return _bits((1, 1), (2, 2), (0, 5), (0, 5), (15, 4),
                 *[(1, 3)] * 19) + bytes(64)


ERRORS = {
    # name: (stream, the DeflateError text)
    "reserved_btype": (lambda: _bits((1, 1), (3, 2)), "bad block method"),
    "stored_len_nlen_broken": (
        lambda: _bits((1, 1), (0, 2))[:1] + b"\x05\x00\x00\x00xxxxx",
        "malformed stored block"),
    "truncated_dynamic": (lambda: _raw(_bench(20000), 9)[:3000],
                          "invalid Huffman code"),
    "truncated_stored": (
        lambda: (_stored(corpus(3, 5000)) + _stored(corpus(3, 5000), True))[:3000],
        "truncated stream (ran past end without EOB)"),
    "bad_dynamic_header": (_bad_header, "invalid Huffman code"),
    "distance_before_start": (
        lambda: _raw(corpus(2, 3000), 9, zdict=corpus(2, 700)),
        "back-reference distance before stream start"),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_inflate_foreign_device_errors(name):
    make, text = ERRORS[name]
    with pytest.raises(DeflateError) as e:
        TF.inflate_foreign_device(make(), device="cpu")
    assert str(e.value) == f"corrupt stream: {text}"


@pytest.mark.parametrize("device,flags,foreign", [
    ("cpu", {}, False),
    ("cuda", {}, True),
    ("cuda", {"static_only": True}, False),
    ("cuda", {"one_block": True}, False),
])
def test_inflate_device_routes_by_device(monkeypatch, device, flags, foreign):
    """On a CUDA device the device-paced decode runs first; its FALLBACK
    (None) and every other case go to the general pipeline."""
    calls = []
    monkeypatch.setattr(TD, "inflate_foreign_device",
                        lambda *a: calls.append("foreign"))
    monkeypatch.setattr(TD, "_inflate_general",
                        lambda *a: calls.append("general") or "general")
    assert TD.inflate_device(b"\x03\x00", device=device, **flags) == "general"
    assert calls == (["foreign", "general"] if foreign else ["general"])
