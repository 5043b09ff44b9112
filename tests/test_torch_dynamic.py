"""The dynamic-tree path of tpu_deflate_torch against the JAX package on
the same numpy inputs: tree building, the dynamic encoder, the header
parse, the code-length paint (``mono_compact``), the table-driven
tokenizer and the decode of whole lanes.  Every output is integer data,
held to exact equality."""

from __future__ import annotations

import functools
import pathlib
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_deflate as tj  # noqa: E402
import tpu_deflate_torch as td  # noqa: E402
from tests.corpora import corpus  # noqa: E402
from tests.test_torch_kernels import _bits_to_bytes, _zlib_raw  # noqa: E402
from tpu_deflate.kernels.monotone import mono_compact as j_mono_compact  # noqa: E402
from tpu_deflate.kernels.tokenize_dyn import MIN_LIT_LEN  # noqa: E402
from tpu_deflate.kernels.tokenize_dyn import tokenize_dyn_batch as j_tok_dyn  # noqa: E402
from tpu_deflate.ops import decode as JD  # noqa: E402
from tpu_deflate.ops import encode as JE  # noqa: E402
from tpu_deflate_torch.kernels.monotone import mono_compact  # noqa: E402
from tpu_deflate_torch.kernels.tokenize import (  # noqa: E402
    ERR_BAD_CODE,
    ERR_DIST,
    ERR_INPUT,
    ERR_OK,
    ERR_OVERFLOW,
)
from tpu_deflate_torch.kernels.tokenize_dyn import (  # noqa: E402
    TAB_OUTBASE,
    tokenize_dyn_batch,
)
from tpu_deflate_torch.ops import decode as D  # noqa: E402
from tpu_deflate_torch.ops import encode as E  # noqa: E402
from tpu_deflate_torch.spec import tables as T  # noqa: E402

CH = 3072
ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = dict(window=256, max_match=10, chunk_size=CH, dynamic_encode=True)
JCFG, TCFG = tj.DeflateConfig(**FIELDS), td.DeflateConfig(**FIELDS)


def t(x):
    return torch.from_numpy(np.array(x))


def n(x):
    return np.asarray(x)


def _payloads():
    """Prose, seeded letters, seeded random bytes, one repeated byte."""
    rng = np.random.default_rng(1951)
    text = (ROOT / "SURVEY.md").read_bytes() * 4
    return [
        text[:CH],
        bytes(rng.integers(97, 123, CH, np.uint8)),
        bytes(rng.integers(0, 256, CH, np.uint8)),  # stored lane
        b"z" * CH,  # codes shorter than 3 bits
    ]


# ---------------------------------------------------------------------------
# tree building: code lengths, canonical codes, completeness, RLE
# ---------------------------------------------------------------------------


def _freq(case):
    rng = np.random.default_rng(7)
    S, max_bits = {"cl": (19, 7), "dist": (30, 15)}.get(case, (286, 15))
    f = np.zeros(S, np.int64)
    if case == "one":
        f[65] = 40
    elif case == "two":
        f[[3, 256]] = [5, 1]
    elif case == "skewed":
        f[:40] = (2.0 ** -np.arange(40) * 1e9).astype(np.int64) + 1
    elif case == "ties":
        f[::3] = 7  # equal counts: the stable sort decides the promotions
        f[256] = 1
    elif case == "random":
        f[:] = rng.integers(0, 500, S) * (rng.random(S) < 0.6)
    elif case in ("cl", "dist"):
        f[:] = rng.integers(0, 60, S) * (rng.random(S) < 0.7)
    elif case == "zipf":  # a long clipped tail: the repair's many rounds
        f[:] = (1e9 / (1 + np.arange(S)) ** 2.5).astype(np.int64) + (np.arange(S) % 3)
    elif case == "rare_ties":  # equal rare counts: the repair goes by index
        f[:] = 1
        f[[7, 100, 200]] = 1 << 28
    return f, max_bits


@pytest.mark.parametrize("case", ["zero", "one", "two", "skewed", "ties",
                                  "random", "cl", "dist", "zipf", "rare_ties"])
def test_tree_building_equals_jax(case):
    f, max_bits = _freq(case)
    got = E._assign_code_lengths(t(f)[None], max_bits)[0]
    want = n(JE._assign_code_lengths_jax(jnp.asarray(f, jnp.int32), max_bits))
    np.testing.assert_array_equal(got.numpy(), want)
    lengths = jnp.asarray(want, jnp.int32)
    L = t(want).to(torch.int64)[None]
    np.testing.assert_array_equal(E._canonical_codes(L)[0].numpy(),
                                  n(JE._canonical_codes_jax(lengths)))
    assert bool(E._kraft_complete(L, max_bits)[0]) == bool(
        JE._kraft_complete(lengths, max_bits))
    codes = E._canonical_codes(L)
    np.testing.assert_array_equal(
        E._revbits(codes, L.clamp_min(1))[0].numpy(),
        n(JE._revbits_vec(jnp.asarray(codes[0].numpy(), jnp.int32),
                          jnp.maximum(lengths, 1))))
    for got_x, want_x in zip(E._rle_code_lengths(L),
                             JE._rle_code_lengths_jax(lengths)):
        np.testing.assert_array_equal(got_x[0].numpy(), n(want_x))


def _rounds_model(f, lengths, max_bits: int, rounds: int):
    """The overflow repair as the JAX package runs it: ``rounds`` rounds,
    each lengthening the rarest symbol of length 1 .. max_bits - 1 (the
    first by index) while the code is oversubscribed."""
    L = lengths.clone()
    for _ in range(rounds):
        over = (E._kraft(L, max_bits) > (1 << max_bits)).to(torch.int64)
        can = (L > 0) & (L < max_bits)
        pick = torch.argmin(torch.where(can, f, 1 << 30), dim=1)
        L = L.scatter_add(1, pick[:, None], over[:, None])
    return L


@pytest.mark.parametrize("S, max_bits", [(286, 15), (30, 15), (19, 7)])
def test_overflow_repair_closed_form_equals_rounds(S, max_bits):
    """``_overflow_rounds`` adds what the rounds add, with the cap at 48
    and at 3, on seeded rows: lengths by the ceil rule from skewed counts
    (mostly within the budget) and seeded lengths far over it, some of
    which need more than 48 rounds; equal counts among them, all below
    2^30, as a chunk's are."""
    rng = np.random.default_rng(S)
    f = np.concatenate([
        (1e9 / (1 + np.arange(S)) ** rng.uniform(1, 4, (8, 1))).astype(np.int64),
        rng.integers(0, 8, (8, S)) * (rng.random((8, S)) < 0.8)]) + 1
    f = torch.as_tensor(np.minimum(f, (1 << 30) - 1))
    total = f.sum(1, keepdim=True)
    q = total // f
    blen = E._bit_length(q)
    pow2 = (q & (q - 1)) == 0
    ceil_rule = (torch.where(pow2, blen - 1, blen) + (pow2 & (total % f != 0))).clamp(1, max_bits)
    seeded = torch.as_tensor(rng.integers(0, max_bits + 1, (16, S)))
    L0 = torch.cat([ceil_rule, seeded])
    f = torch.cat([f, f])
    need = (_rounds_model(f, L0, max_bits, 1000) - L0).sum(1)
    assert int(need.max()) > 48 and int((need == 0).sum()) > 0
    for rounds in (48, 3):
        got = L0 + E._overflow_rounds(f, L0, max_bits, rounds)
        assert torch.equal(got, _rounds_model(f, L0, max_bits, rounds))


def test_rle_runs_equal_jax():
    """Long zero runs (18 and 17 ops), repeats (16 ops) and short runs."""
    L = np.array([0] * 140 + [5] * 9 + [0] * 12 + [3, 3, 0, 0] + [0] * 5
                 + [7] * 4 + [8] * 2 + [0] * 139 + [1], np.int64)
    got = E._rle_code_lengths(t(L)[None])
    want = JE._rle_code_lengths_jax(jnp.asarray(L, jnp.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), n(w))


# ---------------------------------------------------------------------------
# the dynamic encoder
# ---------------------------------------------------------------------------


def _encode_lanes(chunk):
    rows = [p[:chunk].ljust(chunk, b"\0") for p in _payloads()]
    rows += [corpus(m, chunk - 37 * m).ljust(chunk, b"\0") for m in range(8)]
    lens = np.full(len(rows), chunk, np.int32)
    lens[4:] = [chunk - 37 * m for m in range(8)]
    lens[-1] = 100  # a short lane
    data = np.frombuffer(b"".join(rows), np.uint8).reshape(len(rows), chunk)
    finals = np.arange(len(rows)) % 3 == 2
    return data.copy(), lens, finals


@pytest.mark.parametrize("chunk", [CH, 4096])
def test_dynamic_encode_blocks_batch_equal(chunk):
    data, lens, finals = _encode_lanes(chunk)
    cfg = dict(FIELDS, chunk_size=chunk)
    out, out_lens, ntok = E.encode_blocks_batch(
        t(data), t(lens), t(finals), td.DeflateConfig(**cfg))
    jout, jlens, jntok = JE.encode_blocks_batch(
        jnp.asarray(data), jnp.asarray(lens), jnp.asarray(finals),
        tj.DeflateConfig(**cfg))
    np.testing.assert_array_equal(out_lens.numpy(), n(jlens))
    np.testing.assert_array_equal(ntok.numpy(), n(jntok))
    np.testing.assert_array_equal(out.numpy(), n(jout))
    btypes = set()
    for b in range(len(lens)):
        body = out[b, : out_lens[b]].numpy().tobytes()
        btypes.add((body[0] >> 1) & 3)
        got = zlib.decompressobj(-15).decompress(body)
        assert got == data[b, : lens[b]].tobytes(), b
    assert {0, 2} <= btypes  # stored and dynamic lanes


@pytest.mark.parametrize("extra", [{"window": 32768}, {"lazy": True}])
def test_dynamic_config_raises_only_where_unported(extra):
    """The dynamic options the port once refused (the full window, the
    lazy parse) now encode as the JAX package's, lanes and all; zeros
    still encode with TCFG."""
    data, lens, finals = _encode_lanes(CH)
    cfg = {**FIELDS, **extra}
    out, out_lens, ntok = E.encode_blocks_batch(
        t(data), t(lens), t(finals), td.DeflateConfig(**cfg))
    jout, jlens, jntok = JE.encode_blocks_batch(
        jnp.asarray(data), jnp.asarray(lens), jnp.asarray(finals),
        tj.DeflateConfig(**cfg))
    np.testing.assert_array_equal(out_lens.numpy(), n(jlens))
    np.testing.assert_array_equal(ntok.numpy(), n(jntok))
    np.testing.assert_array_equal(out.numpy(), n(jout))
    zeros = torch.zeros(1, 4096, dtype=torch.uint8)
    out, out_lens, _ = E.encode_blocks_batch(
        zeros, torch.tensor([4096], dtype=torch.int32), torch.tensor([True]), TCFG)
    assert zlib.decompress(out[0, : out_lens[0]].numpy().tobytes(), -15) == bytes(4096)


# ---------------------------------------------------------------------------
# decode lanes: the dynamic container, zlib streams, broken headers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _container():
    """The payloads through the JAX package's dynamic encoder: (payloads,
    rows uint8[4, M], sizes)."""
    payloads = _payloads()
    data = np.frombuffer(b"".join(payloads), np.uint8).reshape(4, CH)
    finals = np.array([False, False, False, True])
    out, sizes, _ = JE.encode_blocks_batch(
        jnp.asarray(data), jnp.full(4, CH, jnp.int32), jnp.asarray(finals),
        config=JCFG)
    return payloads, n(out), n(sizes)


def _dyn_header(hlit, hdist, cl_lengths, tail_bits, tail_len=400):
    """A dynamic block header with the given counts and the 19 code-length
    code lengths (RFC order), then tail_len copies of a bit."""
    f = [(1, 1), (2, 2), (hlit - 257, 5), (hdist - 1, 5), (19 - 4, 4)]
    f += [(int(cl_lengths[s]), 3) for s in T.CODE_LENGTH_ORDER]
    f += [(tail_bits, 1)] * tail_len
    return _bits_to_bytes(f)


def _stored(payload):
    """A non-final stored block."""
    n = len(payload)
    return bytes([0]) + n.to_bytes(2, "little") + (n ^ 0xFFFF).to_bytes(
        2, "little") + payload


def _dict_raw(payload, zdict):
    """A raw zlib -9 stream of payload whose matches may reach into zdict,
    the output before it."""
    co = zlib.compressobj(9, zlib.DEFLATED, -15, zdict=zdict)
    return co.compress(payload) + co.flush()


def _decode_lanes():
    """(name, stream, end bit) per lane."""
    payloads, rows, sizes = _container()
    lanes = [(f"container{i}", rows[i, : sizes[i]].tobytes(), None)
             for i in range(4)]
    text = (ROOT / "SURVEY.md").read_bytes()
    zl9 = _zlib_raw(text[:2500], 9)
    lanes += [
        ("zlib9", zl9, None),
        ("fixed", _zlib_raw(text[3000:5000], strategy=zlib.Z_FIXED), None),
        ("corrupt_mid", bytes(b ^ 0xA5 if i == len(zl9) // 2 else b
                              for i, b in enumerate(zl9)), None),
        # 19 code-length codes of one bit: oversubscribed
        ("cl_oversub", _dyn_header(257, 1, [1] * 19, 1), None),
        # codes 0 and 16 of one bit, then all ones: a repeat with nothing
        # before it
        ("cl_bad16", _dyn_header(257, 1, [1 if s in (0, 16) else 0
                                          for s in range(19)], 1), None),
        # codes 0 and 1 of one bit, then 258 lengths of 1: oversubscribed
        ("lit_oversub", _dyn_header(257, 1, [1 if s in (0, 1) else 0
                                             for s in range(19)], 1), None),
        ("truncated", zl9, 4 * len(zl9)),
        ("truncated_header", zl9, 8 * 6),
        ("empty", b"", 0),
        ("method3", b"\x07\x00", None),
        # a dynamic block after stored blocks: the static kernel reads the
        # stored ones, the dynamic kernel goes on from its tokens
        ("stored_dyn", _stored(b"hello") + zl9, None),
        ("stored2_dyn", _stored(b"ab") + _stored(b"cd") + zl9, None),
        ("stored_dict", _stored(text[:300]) + _dict_raw(
            text[300:2300], text[:300]), None),
        ("stored_far", _stored(text[200:300]) + _dict_raw(
            text[300:2300], text[:300]), None),
        ("stored_cl_oversub", _stored(b"x") + _dyn_header(257, 1, [1] * 19, 1),
         None),
        ("stored_truncated", _stored(b"hello") + zl9, 8 * (10 + 6)),
        ("stored_overflow", _stored(b"q") + _zlib_raw(bytes(
            np.random.default_rng(5).integers(65, 123, 3200, np.uint8)), 9),
         None),
    ]
    return [(name, s, 8 * len(s) if end is None else end)
            for name, s, end in lanes]


def _rows(lanes):
    M = max(len(s) for _, s, _ in lanes)
    rows = np.zeros((len(lanes), M), np.uint8)
    for i, (_, s, _) in enumerate(lanes):
        rows[i, : len(s)] = np.frombuffer(s, np.uint8)
    return rows, np.array([e for _, _, e in lanes], np.int32)


def test_dyn_header_params_batch_equal():
    lanes = _decode_lanes()
    rows, ends = _rows(lanes)
    got = D.dyn_header_params_batch(t(rows), t(ends))
    want = JD.dyn_header_params_batch(jnp.asarray(rows), jnp.asarray(ends))
    for key in ("ok", "start", "min_len", "tab"):
        for i, (name, _, _) in enumerate(lanes):
            np.testing.assert_array_equal(got[key][i].numpy(), n(want[key])[i],
                                          err_msg=f"{key} {name}")
    ok = dict(zip([name for name, _, _ in lanes], got["ok"].tolist()))
    assert ok["container0"] == ok["zlib9"] == ok["fixed"] == 1
    assert ok["cl_oversub"] == ok["cl_bad16"] == ok["lit_oversub"] == 0


def test_dyn_header_params_at_base_equal():
    """A header after stored blocks starts on a byte, k: parsed at bit 8k,
    it gives the JAX package's parse of the row from byte k on, with its
    bits moved by 8k and the output before it in the table."""
    lanes = [ln for ln in _decode_lanes() if ln[0].startswith("stored")]
    rows, ends = _rows(lanes)
    k = np.array([len(_stored(b"hello")), 2 * len(_stored(b"ab")),
                  len(_stored(b"x" * 300)), len(_stored(b"x" * 100)),
                  len(_stored(b"x")), len(_stored(b"hello")),
                  len(_stored(b"q"))])
    assert [name for name, _, _ in lanes] == [
        "stored_dyn", "stored2_dyn", "stored_dict", "stored_far",
        "stored_cl_oversub", "stored_truncated", "stored_overflow"]
    out_base = np.arange(len(lanes)) * 11
    got = D.dyn_header_params_batch(t(rows), t(ends), t(8 * k), t(out_base))
    shifted = np.zeros_like(rows)
    for i in range(len(lanes)):
        shifted[i, : rows.shape[1] - k[i]] = rows[i, k[i]:]
    want = JD.dyn_header_params_batch(jnp.asarray(shifted),
                                      jnp.asarray(ends - 8 * k))
    tab = n(want["tab"]).copy()
    tab[:, 153] += 8 * k  # the first symbol's bit
    tab[:, TAB_OUTBASE] = out_base
    np.testing.assert_array_equal(got["tab"].numpy(), tab)
    np.testing.assert_array_equal(got["start"].numpy(), n(want["start"]) + 8 * k)
    for key in ("ok", "min_len"):
        np.testing.assert_array_equal(got[key].numpy(), n(want[key]))
    assert (got["btype"] == 2).all()


def _cl_inputs(rows):
    """Each lane's code-length code, read as the JAX package's header parse
    reads it: (pos0, target, cl_lengths) numpy."""
    bits = np.unpackbits(rows[:, :16], axis=1, bitorder="little").astype(np.int64)

    def field(p, nb):
        return (bits[:, p : p + nb] << np.arange(nb)).sum(1)

    hlit, hdist, hclen = field(3, 5) + 257, field(8, 5) + 1, field(13, 4) + 4
    cl = np.zeros((len(rows), 19), np.int64)
    for j in range(19):
        cl[:, T.CODE_LENGTH_ORDER[j]] = np.where(j < hclen, field(17 + 3 * j, 3), 0)
    return 17 + 3 * hclen, hlit + hdist, cl


def test_decode_cl_lengths_equal():
    lanes = [ln for ln in _decode_lanes() if ln[0] in (
        "container0", "container1", "container3", "zlib9", "cl_bad16",
        "lit_oversub", "truncated_header")]
    rows, _ = _rows(lanes)
    rows = np.pad(rows, ((0, 0), (0, JD.CL_WIN // 8 + 64)))
    pos0, target, cl = _cl_inputs(rows)
    lim, rd, sym, over = D.canon_params(t(cl), 19)
    got = D.decode_cl_lengths(t(rows).to(torch.int64), t(pos0), t(target),
                              lim, rd, sym)
    for i, (name, _, _) in enumerate(lanes):
        jlim, jrd, jmeta, jover = JD._canon_params_jax(
            jnp.asarray(cl[i], jnp.int32), 19, lambda s, xp=np: s)
        for g, w in zip((lim, rd, sym, over), (jlim, jrd, jmeta, jover)):
            np.testing.assert_array_equal(g[i].numpy(), n(w), err_msg=name)
        want = jax.jit(JD._decode_cl_lengths)(
            jnp.asarray(rows[i]), int(pos0[i]), int(target[i]), jlim, jrd, jmeta)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), n(w), err_msg=name)
    assert got[2].tolist() == [True, True, True, True, False, True, True]


@pytest.mark.parametrize("case", ["static", "container", "random"])
def test_pack_block_tab_equal(case):
    rng = np.random.default_rng(11)
    B = 4
    if case == "static":
        lit = np.tile(T.STATIC_LITLEN_LENGTHS, (B, 1))
        dist = np.tile(T.STATIC_DIST_LENGTHS, (B, 1))
    elif case == "container":
        f = t(rng.integers(0, 300, (B, 288)) * (rng.random((B, 288)) < 0.8))
        lit = np.pad(E._assign_code_lengths(f[:, :286], 15).numpy(), ((0, 0), (0, 2)))
        dist = np.pad(E._assign_code_lengths(f[:, :30], 15).numpy(), ((0, 0), (0, 2)))
    else:  # arbitrary lengths, most trees oversubscribed or incomplete
        lit = rng.integers(0, 16, (B, 288)) * (rng.random((B, 288)) < 0.3)
        dist = rng.integers(0, 16, (B, 32)) * (rng.random((B, 32)) < 0.5)
        dist[0] = 0  # no distance code at all
    start = rng.integers(0, 5000, B)
    got = D.pack_block_tab(t(lit).long(), t(dist).long(), t(start).long())
    want = jax.vmap(JD.pack_block_tab)(jnp.asarray(lit, jnp.int32),
                                       jnp.asarray(dist, jnp.int32),
                                       jnp.asarray(start, jnp.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), n(w))


# ---------------------------------------------------------------------------
# mono_compact: the code-length paint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,size", [(4608, 320), (3000, 700)])
def test_mono_compact_equals_pallas_interpret(K, size):
    rng = np.random.default_rng(K)
    B, C = 3, 2
    idx = np.full((B, K), size, np.int32)
    vals = rng.integers(0, 1 << 16, (B, C, K)).astype(np.int32)
    for b in range(B):
        live = np.sort(rng.choice(K, min(K, 2 * size), replace=False))
        step = rng.integers(0, 2, len(live))  # repeats and steps of one
        step[0] = 0
        tgt = np.cumsum(step)
        keep = tgt < size
        idx[b, live[keep]] = tgt[keep]
    idx[2, :] = size  # an all-dead lane
    vals[0, :, idx[0] == size] = rng.integers(0, 99, (int((idx[0] == size).sum()), C))
    got = mono_compact(t(idx), t(vals), size)
    for b in range(B):
        want = j_mono_compact(jnp.asarray(idx[b]), jnp.asarray(vals[b]), size,
                              interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), n(want))


# ---------------------------------------------------------------------------
# tokenize: the plain version against the Pallas kernel on its own tables
# ---------------------------------------------------------------------------


def test_tokenize_dyn_plain_equals_pallas_interpret():
    """Gated lanes (valid trees, codes of 3 bits or more), fed the JAX
    header parse's tables and starts."""
    payloads, rows, sizes = _container()
    ends = (8 * sizes).astype(np.int32)
    prep = JD.dyn_header_params_batch(jnp.asarray(rows), jnp.asarray(ends))
    gate = (n(prep["ok"]) == 1) & (n(prep["min_len"]) >= MIN_LIT_LEN)
    assert gate.sum() >= 2
    tok, ntok, tot, endp, err = (n(x) for x in j_tok_dyn(
        jnp.asarray(rows), jnp.asarray(ends), prep["tab"], prep["start"],
        pw=JD._fused_pw(CH), interpret=True))
    got = [x.numpy() for x in tokenize_dyn_batch(
        t(rows), t(ends), t(n(prep["tab"])), t(n(prep["start"])),
        torch.full((4,), -1, dtype=torch.int32),
        torch.zeros(4, dtype=torch.int32), CH + 16, D.chunk_pwin(CH))]
    tk, ta, tb, tp, gtot, pos, gerr = got
    for i in np.nonzero(gate)[0]:
        k = int(ntok[i])
        assert (tp[i], gtot[i], pos[i], gerr[i]) == (k, tot[i], endp[i], err[i])
        np.testing.assert_array_equal(tk[i, :k], (tok[i, :k] >> 26) & 3)
        np.testing.assert_array_equal(ta[i, :k], (tok[i, :k] >> 17) & 0x1FF)
        np.testing.assert_array_equal(tb[i, :k], tok[i, :k] & 0x1FFFF)
        assert not tk[i, k:].any() and not ta[i, k:].any()


@pytest.mark.parametrize("out_base,tok0", [(0, 0), (100, 1), (300, 7)])
def test_tokenize_dyn_out_base_equals_pallas_interpret(out_base, tok0):
    """A block whose matches reach up to 300 bytes before it: the table's
    out_base (output before the block) decides ERR_DIST as in the JAX
    kernel.  The port's tokens follow tok0 earlier ones, and its counts
    include both."""
    text = (ROOT / "SURVEY.md").read_bytes()
    lane = _dict_raw(text[300:2300], text[:300])
    rows = np.frombuffer(lane, np.uint8)[None].copy()
    ends = np.array([8 * len(lane)], np.int32)
    prep = JD.dyn_header_params_batch(jnp.asarray(rows), jnp.asarray(ends))
    assert int(prep["ok"][0]) == 1
    assert int(prep["min_len"][0]) >= MIN_LIT_LEN
    tab = n(prep["tab"]).copy()
    tab[:, TAB_OUTBASE] = out_base
    tok, ntok, tot, endp, err = (n(x) for x in j_tok_dyn(
        jnp.asarray(rows), jnp.asarray(ends), jnp.asarray(tab), prep["start"],
        pw=JD._fused_pw(CH), interpret=True))
    tk, ta, tb, tp, gtot, pos, gerr = (x.numpy() for x in tokenize_dyn_batch(
        t(rows), t(ends), t(tab), t(n(prep["start"])),
        torch.full((1,), -1, dtype=torch.int32),
        torch.full((1,), tok0, dtype=torch.int32), CH + 16, D.chunk_pwin(CH)))
    k = int(ntok[0])
    assert (tp[0], gtot[0], pos[0], gerr[0]) == (
        tok0 + k, out_base + tot[0], endp[0], err[0])
    assert (gerr[0] == ERR_DIST) == (out_base < 300)
    got = tk[0, tok0 : tok0 + k], ta[0, tok0 : tok0 + k], tb[0, tok0 : tok0 + k]
    want = (tok[0, :k] >> 26) & 3, (tok[0, :k] >> 17) & 0x1FF, tok[0, :k] & 0x1FFFF
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not tk[0, :tok0].any() and not ta[0, :tok0].any()


# ---------------------------------------------------------------------------
# decode_rows_batch(static_only=False) against tokenize + expand per lane
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_lanes(pwin):
    lanes = _decode_lanes()
    rows, ends = _rows(lanes)
    jtok = jax.jit(jax.vmap(lambda row, e: JD.tokenize(
        row, 0, tok_cap=CH + 16, end_bit=e, pwin=pwin, stop_at_eob=True,
        static_only=False)))
    want = jtok(jnp.asarray(rows), jnp.asarray(ends))
    out, total = JD.expand_batch(jnp.asarray(rows), *want[:4], out_cap=CH)
    return lanes, rows, ends, [n(x) for x in want], n(out), n(total)


@pytest.mark.parametrize("pwin", [D.chunk_pwin(CH), 17 << 6])
def test_decode_rows_dynamic_equals_xla_tokenize(pwin):
    lanes, rows, ends, want, jout, jtotal = _jax_lanes(pwin)
    got = [x.numpy() for x in D.tokenize_rows_batch(
        t(rows), t(ends), CH + 16, pwin, static_only=False)]
    for i, (name, _, _) in enumerate(lanes):
        k = int(want[3][i])
        for j, field in enumerate(("ntok", "out_total", "end_pos", "err"), 3):
            assert got[j][i] == want[j][i], (name, field, got[j][i], want[j][i])
        for j in range(3):
            np.testing.assert_array_equal(got[j][i, :k], want[j][i, :k],
                                          err_msg=name)
    codes = dict(zip([name for name, _, _ in lanes], got[6].tolist()))
    assert codes["container0"] == codes["zlib9"] == codes["empty"] == ERR_OK
    assert codes["container3"] == codes["container2"] == codes["fixed"] == ERR_OK
    assert codes["cl_oversub"] == codes["cl_bad16"] == ERR_BAD_CODE
    assert codes["lit_oversub"] == ERR_BAD_CODE
    assert codes["truncated"] in (ERR_BAD_CODE, ERR_INPUT)
    assert codes["stored_dyn"] == codes["stored2_dyn"] == ERR_OK
    assert codes["stored_dict"] == ERR_OK
    assert codes["stored_far"] == ERR_DIST
    assert codes["stored_cl_oversub"] == codes["stored_truncated"] == ERR_BAD_CODE
    assert codes["stored_overflow"] == ERR_OVERFLOW

    if pwin == D.chunk_pwin(CH):
        out, total, err = (x.numpy() for x in D.decode_rows_batch(
            t(rows), t(ends), out_cap=CH, tok_cap=CH + 16, static_only=False))
        np.testing.assert_array_equal(err, got[6])
        for i, (name, _, _) in enumerate(lanes):
            if err[i] == ERR_OK:
                assert total[i] == jtotal[i], name
                np.testing.assert_array_equal(out[i], jout[i], err_msg=name)
        payloads = _container()[0]
        for i in range(4):
            assert out[i, : total[i]].tobytes() == payloads[i]


# ---------------------------------------------------------------------------
# the slice: compress_indexed -> decompress_indexed, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["payloads", 0, 3, 6])
def test_dynamic_indexed_round_trip_equal(case):
    if case == "payloads":
        data = b"".join(_payloads()) + corpus(1, 1000)
    else:
        data = corpus(case, 4 * CH - 500)
    stream, index = td.compress_indexed(data, TCFG, device="cpu")
    jstream, jindex = tj.compress_indexed(data, JCFG)
    assert stream == jstream
    np.testing.assert_array_equal(index, jindex)
    assert zlib.decompress(stream) == data
    assert td.decompress_indexed(stream, index, TCFG, device="cpu") == data
    assert tj.decompress_indexed(stream, index, JCFG) == data
    # a decoder that takes static trees first finds the dynamic lanes, and
    # one configured without dynamic trees refuses them
    static_first = td.DeflateConfig(chunk_size=CH)
    assert td.decompress_indexed(stream, index, static_first, device="cpu") == data
    starts = 2 + np.concatenate([[0], np.cumsum(index)[:-1]])
    if any((stream[s] >> 1) & 3 == 2 for s in starts):
        with pytest.raises(td.DeflateError):
            td.decompress_indexed(stream, index, td.DeflateConfig(
                chunk_size=CH, dynamic=False), device="cpu")
