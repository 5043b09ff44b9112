"""The gzip containers of tpu_deflate_torch against the JAX package's and
stock gzip: compress_gzip, compress_gzip_members and decompress_gzip,
byte for byte and error for error."""

from __future__ import annotations

import dataclasses
import gzip
import io
import pathlib
import zlib

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import tpu_deflate as tj  # noqa: E402
import tpu_deflate_torch as td  # noqa: E402
from tests.corpora import corpus  # noqa: E402

CHUNK = 4096
FIELDS = dataclasses.asdict(tj.DeflateConfig(chunk_size=CHUNK))
DYN = dict(FIELDS, dynamic_encode=True)
CORPUS = pathlib.Path(__file__).resolve().parent / "data" / "corpus.bin.gz"


def _cfgs(fields):
    return tj.DeflateConfig(**fields), td.DeflateConfig(**fields)


def _input(case):
    """Inputs of one batch shape: four chunks, the last one partial."""
    if case == "corpus":
        return gzip.decompress(CORPUS.read_bytes())[: 4 * CHUNK - 300]
    return corpus(case, 4 * CHUNK - 300)


def _raised(fn):
    """(type, text) of what fn raises; the two packages' DeflateError
    compare by name, every other type by identity."""
    with pytest.raises(Exception) as e:
        fn()
    kind = type(e.value)
    if kind in (tj.DeflateError, td.DeflateError):
        kind = "DeflateError"
    return kind, str(e.value)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fields", [FIELDS, DYN], ids=["static", "dynamic"])
@pytest.mark.parametrize("case", [0, 2, 3, 6, "corpus"])
def test_compress_gzip_equal(fields, case):
    data = _input(case)
    jcfg, tcfg = _cfgs(fields)
    got = td.compress_gzip(data, tcfg, device="cpu")
    assert got == tj.compress_gzip(data, jcfg)
    assert gzip.decompress(got) == data
    # its body is compress's DEFLATE body
    assert got[10:-8] == td.compress(data, tcfg, device="cpu")[2:-4]


@pytest.mark.parametrize("fields", [FIELDS, DYN], ids=["static", "dynamic"])
@pytest.mark.parametrize("case", [0, 2, 3, 6, "corpus"])
def test_compress_gzip_members_equal(fields, case):
    data = _input(case)
    jcfg, tcfg = _cfgs(fields)
    got = td.compress_gzip_members(data, tcfg, device="cpu")
    assert got == tj.compress_gzip_members(data, jcfg)
    assert gzip.decompress(got) == data


def test_compress_gzip_ignores_config_compress():
    """Neither package's compress_gzip checks config.compress."""
    fields = dict(FIELDS, compress=False, match10=False)
    jcfg, tcfg = _cfgs(fields)
    data = _input(1)
    assert td.compress_gzip(data, tcfg, device="cpu") == tj.compress_gzip(data, jcfg)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fields", [FIELDS, DYN], ids=["static", "dynamic"])
@pytest.mark.parametrize("case", [0, 3, 5, "corpus"])
def test_decompress_members_equal(fields, case):
    data = _input(case)
    jcfg, tcfg = _cfgs(fields)
    g = td.compress_gzip_members(data, tcfg, device="cpu")
    got = td.decompress_gzip(g, tcfg, device="cpu")
    assert got == tj.decompress_gzip(g, jcfg) == data


def _foreign_data():
    return b"".join(corpus(m, 13000) for m in [1, 3, 0])


@pytest.mark.parametrize("level", [1, 6, 9])
def test_decompress_foreign_equal(level):
    data = _foreign_data()
    g = gzip.compress(data, level)
    jcfg, tcfg = _cfgs(FIELDS)
    got = td.decompress_gzip(g, tcfg, device="cpu")
    assert got == tj.decompress_gzip(g, jcfg) == data


def _member(payload: bytes, level: int, flags: int, name=b"", comment=b"",
            extra=b"") -> bytes:
    """A gzip member with the header fields that flags names (FEXTRA,
    FNAME, FCOMMENT, FHCRC)."""
    head = bytearray(b"\x1f\x8b\x08" + bytes([flags]) + b"\x00" * 4 + b"\x00\xff")
    if flags & 0x04:
        head += len(extra).to_bytes(2, "little") + extra
    if flags & 0x08:
        head += name + b"\x00"
    if flags & 0x10:
        head += comment + b"\x00"
    if flags & 0x02:
        head += (zlib.crc32(bytes(head)) & 0xFFFF).to_bytes(2, "little")
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = co.compress(payload) + co.flush()
    return (bytes(head) + body + zlib.crc32(payload).to_bytes(4, "little")
            + (len(payload) & 0xFFFFFFFF).to_bytes(4, "little"))


@pytest.mark.parametrize("layout", ["fname_fcomment", "fhcrc_fextra"])
def test_decompress_foreign_header_fields_equal(layout):
    data = _foreign_data()
    if layout == "fname_fcomment":
        # a GzipFile member with FNAME, then one with FNAME and FCOMMENT
        buf = io.BytesIO()
        with gzip.GzipFile(fileobj=buf, mode="wb", filename="a.txt", mtime=0) as f:
            f.write(data[:5000])
        stream = buf.getvalue() + _member(data[5000:9000], 1, 0x18, b"b.txt",
                                          b"a comment")
        want = data[:9000]
    else:
        stream = (_member(data[:7000], 9, 0x02)
                  + _member(data[7000:20000], 6, 0x1E, b"c", b"d", b"xy\x02\x00ab"))
        want = data[:20000]
    assert gzip.decompress(stream) == want
    jcfg, tcfg = _cfgs(FIELDS)
    got = td.decompress_gzip(stream, tcfg, device="cpu")
    assert got == tj.decompress_gzip(stream, jcfg) == want


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


def _members(data=None):
    data = _input(0) if data is None else data
    return bytearray(td.compress_gzip_members(data, td.DeflateConfig(**FIELDS),
                                              device="cpu"))


def _damaged(what):
    """(stream, fields) of a damaged input."""
    if what == "body":  # a literal changes
        g = _members()
        g[30] ^= 0x20
    elif what == "block_type":  # the first block becomes of type 3
        g = _members()
        g[20] ^= 0x04
    elif what == "crc":
        g = _members()
        end = int.from_bytes(g[16:20], "little")
        g[end - 8] ^= 0x01
    elif what == "isize":
        g = _members()
        end = int.from_bytes(g[16:20], "little")
        g[end - 4] ^= 0x01  # 4096 -> 4097, above the chunk size
    elif what == "isize_small":
        g = _members()
        end = int.from_bytes(g[16:20], "little")
        g[end - 3] ^= 0x10  # 4096 -> 0
    elif what == "larger_than_chunk":
        g = _members()
        return bytes(g), dict(FIELDS, chunk_size=1024)
    elif what == "foreign_crc":
        g = bytearray(gzip.compress(_input(0), 6))
        g[-6] ^= 0x01
    elif what == "foreign_isize":
        g = bytearray(gzip.compress(_input(0), 6))
        g[-2] ^= 0x01
    elif what == "foreign_body":
        g = bytearray(gzip.compress(_input(0), 6))
        g[40] ^= 0x55
    elif what == "bad_magic":
        g = bytearray(b"\x1f\x8c" + gzip.compress(_input(0))[2:])
    elif what == "bad_method":
        g = bytearray(gzip.compress(_input(0)))
        g[2] = 7
    elif what == "trailing_garbage":
        g = bytearray(gzip.compress(_input(0)) + b"\x00\x01")
    else:
        assert what == "empty"
        g = bytearray()
    return bytes(g), FIELDS


# what each damage raises (a prefix of the text)
EXPECT = {
    "body": (ValueError, "member 0 CRC-32 mismatch"),
    "block_type": (ValueError, "inflate error codes [1]"),
    "crc": (ValueError, "member 0 CRC-32 mismatch"),
    "isize": (ValueError, "member larger than config.chunk_size"),
    "isize_small": (ValueError, "member 0 ISIZE mismatch"),
    "larger_than_chunk": (ValueError, "member larger than config.chunk_size"),
    "foreign_crc": ("DeflateError", "gzip CRC-32 mismatch"),
    "foreign_isize": ("DeflateError", "gzip ISIZE mismatch"),
    "foreign_body": ("DeflateError", "corrupt stream"),
    "bad_magic": ("DeflateError", "bad gzip magic"),
    "bad_method": ("DeflateError", "unsupported gzip method"),
    "trailing_garbage": ("DeflateError", "bad gzip magic"),
    "empty": (OverflowError, ""),
}


@pytest.mark.parametrize("what", sorted(EXPECT))
def test_decompress_errors_alike(what):
    stream, fields = _damaged(what)
    jcfg, tcfg = _cfgs(fields)
    want = _raised(lambda: tj.decompress_gzip(stream, jcfg))
    got = _raised(lambda: td.decompress_gzip(stream, tcfg, device="cpu"))
    kind, text = EXPECT[what]
    assert got[0] is want[0] if isinstance(kind, type) else got[0] == want[0]
    assert got[0] == kind and got[1].startswith(text)
    if what == "empty":  # JAX overflows in its batch pad; the port says why
        assert got[1] == "decompress_gzip: no gzip member"
    else:
        assert got[1] == want[1]
