"""tpu_deflate_torch's host modules against the JAX package's: the bit
writer and reader, the Huffman and checksum helpers, and the reference
codecs (``ref/deflate.py``, ``ref/inflate.py``), byte for byte and error
text for error text, with zlib and gzip as oracles."""

from __future__ import annotations

import gzip
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")

import tpu_deflate.ref.deflate as jdef  # noqa: E402
import tpu_deflate.ref.inflate as jinf  # noqa: E402
import tpu_deflate.spec.bitstream as jbs  # noqa: E402
import tpu_deflate.spec.checksum as jck  # noqa: E402
import tpu_deflate.spec.huffman as jhuf  # noqa: E402
import tpu_deflate.spec.tables as jtab  # noqa: E402
import tpu_deflate_torch.ref.deflate as tdef  # noqa: E402
import tpu_deflate_torch.ref.inflate as tinf  # noqa: E402
import tpu_deflate_torch.spec.bitstream as tbs  # noqa: E402
import tpu_deflate_torch.spec.checksum as tck  # noqa: E402
import tpu_deflate_torch.spec.huffman as thuf  # noqa: E402
from tests.corpora import corpus  # noqa: E402
from tpu_deflate.config import DeflateConfig as JConfig  # noqa: E402
from tpu_deflate_torch.config import DeflateConfig as TConfig  # noqa: E402

ENCODE_CONFIGS = [
    {},
    {"window": 32, "max_match": 5},
    {"window": 32768, "max_match": 258},
    {"window": 32768, "max_match": 258, "dynamic_encode": True},
    {"window": 1024, "max_match": 18, "dynamic_encode": True},
]


def test_bit_writer_reader_round_trip():
    rng = np.random.default_rng(11)
    widths = rng.integers(0, 25, 400)
    values = [int(rng.integers(0, 1 << w)) if w else 0 for w in widths]
    tw, jw = tbs.BitWriter(), jbs.BitWriter()
    for v, w in zip(values, widths):
        tw.write_bits(v, int(w))
        jw.write_bits(v, int(w))
    assert tw.bit_length == jw.bit_length == int(widths.sum())
    tw.write_bytes(b"\x01\x02")
    jw.write_bytes(b"\x01\x02")
    buf = tw.getvalue()
    assert buf == jw.getvalue()
    r = tbs.BitReader(buf)
    for v, w in zip(values, widths):
        assert r.peek_bits(int(w)) == v
        assert r.read_bits(int(w)) == v
    assert r.read_bytes(2) == b"\x01\x02"
    assert r.bits_remaining == 0 and r.byte_position == len(buf)
    with pytest.raises(EOFError):
        r.read_bytes(1)
    with pytest.raises(ValueError):
        tbs.BitWriter().write_bits(8, 3)
    r = tbs.BitReader(b"\xff", start_bit=5)
    assert r.read_bits(8) == 0b111  # bits past the end read as 0
    assert r.bit_position == 13


def test_huffman_helpers_equal():
    rng = np.random.default_rng(5)
    for size, max_bits in ((286, 15), (30, 15), (19, 7)):
        for _ in range(6):
            freqs = rng.integers(0, 1000, size) * (rng.random(size) < 0.6)
            freqs[rng.integers(0, size)] = 10**6  # a skewed tree, clipped
            got = thuf.code_lengths_from_freqs(freqs, max_bits)
            np.testing.assert_array_equal(
                got, jhuf.code_lengths_from_freqs(freqs, max_bits))
            assert np.sum(2.0 ** -got[got > 0]) == 1.0
            np.testing.assert_array_equal(thuf.build_decode_table(got),
                                          jhuf.build_decode_table(got))
    for f in ([0, 0, 5], [], [0, 0]):
        np.testing.assert_array_equal(thuf.code_lengths_from_freqs(np.array(f)),
                                      jhuf.code_lengths_from_freqs(np.array(f)))
    leaf = thuf.pack_leaf(np.array([3, 285]), np.array([7, 15]))
    np.testing.assert_array_equal(leaf, jhuf.pack_leaf(np.array([3, 285]),
                                                       np.array([7, 15])))
    np.testing.assert_array_equal(thuf.leaf_symbol(leaf), [3, 285])
    np.testing.assert_array_equal(thuf.leaf_nbits(leaf), [7, 15])


def test_checksums_equal():
    data = corpus(2, 5000)
    for value in (1, 0x12345678):
        assert tck.adler32(data, value) == jck.adler32(data, value)
    assert tck.adler32(data) == zlib.adler32(data)
    assert tck.crc32(data, 7) == jck.crc32(data, 7) == zlib.crc32(data, 7)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 5, 6])
@pytest.mark.parametrize("fields", ENCODE_CONFIGS, ids=str)
def test_reference_encoders_equal(fields, mode):
    data = corpus(mode, 3000)
    tcfg, jcfg = TConfig(**fields), JConfig(**fields)
    z = tdef.zlib_compress(data, tcfg)
    assert z == jdef.zlib_compress(data, jcfg)
    assert zlib.decompress(z) == data
    g = tdef.gzip_compress(data, tcfg)
    assert g == jdef.gzip_compress(data, jcfg)
    assert gzip.decompress(g) == data
    raw = tdef.deflate_raw(data, tcfg, final=False, byte_align=True)
    assert raw == jdef.deflate_raw(data, jcfg, final=False, byte_align=True)
    assert zlib.decompressobj(-15).decompress(raw) == data


def test_reference_matches_equal():
    data = corpus(2, 4000) + corpus(2, 4000)
    for window, max_match in ((32, 5), (256, 10), (32768, 258)):
        assert (tdef.find_matches_greedy(data, window, max_match)
                == jdef.find_matches_greedy(data, window, max_match))


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("mode", [0, 1, 3, 6])
def test_reference_decoders_equal(mode, level):
    data = corpus(mode, 6000)
    z = zlib.compress(data, level)
    assert tinf.zlib_decompress(z) == jinf.zlib_decompress(z) == data
    out, end = tinf.inflate_raw(z, 16)
    assert (out, end) == jinf.inflate_raw(z, 16)
    co = zlib.compressobj(level, zlib.DEFLATED, 31)
    g = co.compress(data) + co.flush() + gzip.compress(data[:999], level)
    assert tinf.gzip_decompress(g) == jinf.gzip_decompress(g) == data + data[:999]


def _gzip_member(payload: bytes, flags: int, fields: bytes) -> bytes:
    head = b"\x1f\x8b\x08" + bytes([flags]) + bytes(4) + b"\x00\xff" + fields
    if flags & 0x02:
        head += (zlib.crc32(head) & 0xFFFF).to_bytes(2, "little")
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    return (head + co.compress(payload) + co.flush()
            + zlib.crc32(payload).to_bytes(4, "little")
            + len(payload).to_bytes(4, "little"))


def test_gzip_header_fields_equal():
    data = corpus(1, 3000)
    g = _gzip_member(data, 0x1E, b"\x02\x00xyb.txt\x00a comment\x00")
    assert tinf.gzip_decompress(g) == jinf.gzip_decompress(g) == data


def _damaged():
    """(name, decoder, stream) of corrupt inputs, one for each error."""
    data = corpus(2, 4000)
    z6 = zlib.compress(data, 6)
    z0 = zlib.compress(data[:500], 0)
    static = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FIXED)
    zs = static.compress(data) + static.flush()
    g = gzip.compress(data[:800])
    out = [
        ("short", "zlib", z6[:5]),
        ("method", "zlib", b"\x79\x9c" + z6[2:]),
        ("check", "zlib", b"\x78\x9d" + z6[2:]),
        ("dict", "zlib", b"\x78\xbb" + z6[2:]),
        ("adler", "zlib", z6[:-1] + bytes([z6[-1] ^ 1])),
        ("trailer", "zlib", z6[:-4]),
        ("nlen", "zlib", z0[:5] + bytes([z0[5] ^ 0xFF]) + z0[6:]),
        ("btype3", "zlib", b"\x78\x9c\x07" + bytes(8)),
        ("gzip_magic", "gzip", b"\x1f\x8c" + g[2:]),
        ("gzip_method", "gzip", g[:2] + b"\x07" + g[3:]),
        ("gzip_crc", "gzip", g[:-8] + bytes([g[-8] ^ 1]) + g[-7:]),
        ("gzip_isize", "gzip", g[:-4] + bytes([g[-4] ^ 1]) + g[-3:]),
        ("static_cut", "zlib", zs[:-40]),
    ]
    # static blocks that open with a length (a distance too far back),
    # with length symbol 286, and with distance symbol 30
    for name, lsym, dsym in (("far", 257, 0), ("bad_len_sym", 286, 0),
                             ("bad_dist_sym", 257, 30)):
        bw = jbs.BitWriter()
        bw.write_bits(0b011, 3)  # BFINAL, static trees
        bw.write_bits(int(jtab.STATIC_LITLEN_CODES_REV[lsym]),
                      int(jtab.STATIC_LITLEN_LENGTHS[lsym]))
        bw.write_bits(int(jtab.STATIC_DIST_CODES_REV[dsym]), 5)
        out.append((name, "raw", bw.getvalue() + bytes(4)))
    # a dynamic header whose first code-length op repeats nothing
    bw = jbs.BitWriter()
    bw.write_bits(1, 1)
    bw.write_bits(2, 2)
    bw.write_bits(0, 5)
    bw.write_bits(0, 5)
    bw.write_bits(15, 4)
    for s in range(19):  # code-length code: every symbol 5 bits long
        bw.write_bits(5, 3)
    bw.write_bits(0b00001, 5)  # symbol 16 (canonical 10000, reversed)
    out.append(("repeat_first", "raw", bw.getvalue() + bytes(8)))
    # a dynamic header that repeats past HLIT + HDIST
    bw = jbs.BitWriter()
    bw.write_bits(1, 1)
    bw.write_bits(2, 2)
    bw.write_bits(0, 5)
    bw.write_bits(0, 5)
    bw.write_bits(15, 4)
    for s in range(19):
        bw.write_bits(5, 3)
    for _ in range(3):  # 3 x 138 zeros > 258
        bw.write_bits(0b01001, 5)  # symbol 18
        bw.write_bits(127, 7)
    out.append(("repeat_overflow", "raw", bw.getvalue() + bytes(8)))
    # a code-length code of one 2-bit code (00), then the code 11
    bw = jbs.BitWriter()
    bw.write_bits(0b101, 3)  # BFINAL, dynamic trees
    bw.write_bits(0, 14)  # HLIT 257, HDIST 1, HCLEN 4
    for length in (0, 0, 0, 2):  # symbols 16, 17, 18, 0
        bw.write_bits(length, 3)
    bw.write_bits(0b11, 2)
    out.append(("invalid_code", "raw", bw.getvalue() + bytes(4)))
    return out


@pytest.mark.parametrize("case", _damaged(), ids=lambda c: c[0])
def test_error_texts_equal(case):
    """The same exception type and text from both decoders."""
    _, kind, stream = case

    def run(mod):
        fn = {"zlib": mod.zlib_decompress, "gzip": mod.gzip_decompress,
              "raw": lambda s: mod.inflate_raw(s, max_output=10**6)}[kind]
        with pytest.raises(Exception) as e:
            fn(stream)
        return e

    got, want = run(tinf), run(jinf)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    if type(want.value).__name__ == "DeflateError":
        assert isinstance(got.value, tinf.DeflateError)


def test_output_limit_equal():
    z = zlib.compress(bytes(5000), 9)
    for mod in (tinf, jinf):
        with pytest.raises(mod.DeflateError, match="output larger than limit"):
            mod.inflate_raw(z, 16, max_output=1000)
