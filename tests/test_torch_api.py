"""The slice as a whole: tpu_deflate_torch's compress_indexed and
decompress_indexed against the JAX package's and stock zlib."""

from __future__ import annotations

import dataclasses
import gzip
import pathlib
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import tpu_deflate as tj  # noqa: E402
import tpu_deflate_torch as td  # noqa: E402
from tests.corpora import corpus  # noqa: E402

CHUNK = 4096
FIELDS = dataclasses.asdict(tj.DeflateConfig(chunk_size=CHUNK))
JCFG, TCFG = tj.DeflateConfig(**FIELDS), td.DeflateConfig(**FIELDS)
CORPUS = pathlib.Path(__file__).resolve().parent / "data" / "corpus.bin.gz"


def _input(case):
    if case == "corpus":
        return gzip.decompress(CORPUS.read_bytes())[: 32 << 10]
    return corpus(case, 4 * CHUNK - 300)


@pytest.mark.parametrize("case", [*range(8), "corpus"])
def test_compress_indexed_round_trip_equal(case):
    data = _input(case)
    stream, index = td.compress_indexed(data, TCFG, device="cpu")
    jstream, jindex = tj.compress_indexed(data, JCFG)
    assert stream == jstream
    np.testing.assert_array_equal(index, jindex)
    assert index.dtype == np.int64
    assert zlib.decompress(stream) == data
    assert td.decompress_indexed(stream, index, TCFG, device="cpu") == data
    assert tj.decompress_indexed(stream, index, JCFG) == data


def test_compress_equal():
    data = _input(1)
    assert td.compress(data, TCFG, device="cpu") == tj.compress(data, JCFG)


def _raises(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value)


@pytest.mark.parametrize("damage", ["body", "index_shift", "index_sum"])
def test_damaged_input_raises_alike(damage):
    data = _input(0)
    stream, index = td.compress_indexed(data, TCFG, device="cpu")
    if damage == "body":
        b = bytearray(stream)
        mid = 2 + int(index[0]) + int(index[1]) // 2
        b[mid] ^= 0x55
        stream = bytes(b)
    elif damage == "index_shift":  # one byte moves from chunk 0 to chunk 1
        index = index.copy()
        index[0] -= 1
        index[1] += 1
    else:
        index = index[:-1]
    got = _raises(lambda: td.decompress_indexed(stream, index, TCFG, device="cpu"))
    want = _raises(lambda: tj.decompress_indexed(stream, index, JCFG))
    assert got is want
    assert issubclass(got, ValueError)


def test_dynamic_block_is_not_ported():
    """A single-block zlib -9 stream (dynamic trees) decodes, equal to the
    JAX package's decode."""
    data = _input(2)
    raw = zlib.compress(data, 9)
    body = raw[2:-4]
    assert (body[0] >> 1) & 3 == 2  # zlib -9 picked a dynamic tree
    index = np.array([len(body)])
    fields = dict(chunk_size=1 << 16)
    got = td.decompress_indexed(raw, index, td.DeflateConfig(**fields),
                                device="cpu")
    assert got == tj.decompress_indexed(raw, index, tj.DeflateConfig(**fields))
    assert got == data


@pytest.mark.parametrize("reach_back", [False, True])
def test_stored_then_dynamic_block_decodes(reach_back):
    """One chunk of a stored block, then a dynamic-tree block whose matches
    may reach into the stored bytes: decoded equal to the JAX package."""
    head = _input(3)[:700]
    data = _input(2)
    co = zlib.compressobj(9, zlib.DEFLATED, -15,
                          **({"zdict": head} if reach_back else {}))
    n = len(head)
    body = (bytes([0]) + n.to_bytes(2, "little")
            + (n ^ 0xFFFF).to_bytes(2, "little") + head
            + co.compress(data) + co.flush())
    assert (body[n + 5] >> 1) & 3 == 2  # the second block has dynamic trees
    raw = b"\x78\x9c" + body + zlib.adler32(head + data).to_bytes(4, "big")
    assert zlib.decompress(raw) == head + data
    index = np.array([len(body)])
    fields = dict(chunk_size=1 << 16)
    got = td.decompress_indexed(raw, index, td.DeflateConfig(**fields),
                                device="cpu")
    assert got == tj.decompress_indexed(raw, index, tj.DeflateConfig(**fields))
    assert got == head + data
