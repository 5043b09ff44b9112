"""decompress_indexed on damaged input: the port raises exactly the JAX
package's exception and text.  Input A is a legal round trip whose lane
overflows its token capacity; input B is a three-chunk stream read with a
shifted index and with a negative index entry.  An index of no chunk
raises the JAX package's type."""

from __future__ import annotations

import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import tpu_deflate as tj  # noqa: E402
import tpu_deflate_torch as td  # noqa: E402

TEXT = (b"hello world, the quick brown fox jumps. " * 400)[:12000]


def _raised(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


def _both(data, fields, index=None):
    """(JAX, port) exception type and text of decompress_indexed of the
    JAX package's compress_indexed of data, read with index if given."""
    jcfg, tcfg = tj.DeflateConfig(**fields), td.DeflateConfig(**fields)
    stream, own = tj.compress_indexed(data, jcfg)
    tstream, town = td.compress_indexed(data, tcfg, device="cpu")
    assert (tstream, list(town)) == (stream, list(own))
    index = own if index is None else np.asarray(index)
    want = _raised(lambda: tj.decompress_indexed(stream, index, jcfg))
    got = _raised(lambda: td.decompress_indexed(stream, index, tcfg,
                                                device="cpu"))
    return want, got


def test_overflow_lane_error_text():
    """Input A: one block of 70000 zero bytes in a 4096-byte chunk's
    token capacity: error 5, with no error names after the codes."""
    want, got = _both(bytes(70000), dict(chunk_size=4096, one_block=True))
    assert want == (ValueError, "inflate error codes [5]")
    assert got == want


@pytest.mark.parametrize("index,text", [
    ([857, 859, 796], "inflate error codes [1]"),  # lane 1 starts a byte early
    ([-5, 1721, 796], "Adler-32 mismatch"),  # lane 1 starts before the body
])
def test_shifted_index_error_text(index, text):
    """Input B with a damaged index (the true one is [858, 858, 796])."""
    fields = dict(window=256, max_match=10, chunk_size=4096)
    want, got = _both(TEXT, fields, index)
    assert want == (ValueError, text)
    assert got == want


def test_true_index_round_trips_alike():
    """Input B with its true index decodes in both packages; the rows the
    port cuts from one padded body hold each chunk's bytes."""
    fields = dict(window=256, max_match=10, chunk_size=4096)
    jcfg, tcfg = tj.DeflateConfig(**fields), td.DeflateConfig(**fields)
    stream, index = tj.compress_indexed(TEXT, jcfg)
    assert list(index) == [858, 858, 796]
    assert td.decompress_indexed(stream, index, tcfg, device="cpu") == TEXT
    assert tj.decompress_indexed(stream, index, jcfg) == TEXT


@pytest.mark.parametrize("trailer", [1, 5])
def test_empty_index_raises_alike(trailer):
    """An empty index on a stream with an empty body: the JAX package's
    batch pad raises OverflowError before it decodes anything, and so does
    the port; zlib rejects the stream with trailer 1 as truncated."""
    stream = b"\x78\x9c" + trailer.to_bytes(4, "big")
    index = np.array([], np.int64)
    cfg = dict(chunk_size=4096)
    want = _raised(lambda: tj.decompress_indexed(stream, index,
                                                 tj.DeflateConfig(**cfg)))
    got = _raised(lambda: td.decompress_indexed(stream, index,
                                                td.DeflateConfig(**cfg),
                                                device="cpu"))
    assert got[0] is want[0] is OverflowError
    if trailer == 1:
        with pytest.raises(zlib.error):
            zlib.decompress(stream)
