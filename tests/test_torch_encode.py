"""tpu_deflate_torch's batched encoder against the JAX package's
encode_blocks_batch: identical bytes, lengths and token counts."""

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

from tests.corpora import corpus  # noqa: E402
from tpu_deflate.api import compress as j_compress  # noqa: E402
from tpu_deflate.config import DeflateConfig as JConfig  # noqa: E402
from tpu_deflate.ops.encode import encode_blocks_batch as j_encode  # noqa: E402
from tpu_deflate_torch.api import compress as t_compress  # noqa: E402
from tpu_deflate_torch.config import DeflateConfig as TConfig  # noqa: E402
from tpu_deflate_torch.ops.encode import encode_blocks_batch  # noqa: E402


def _lanes(chunk):
    """Modes 0-7 as lanes, plus a mixed lane (compressible, then random
    bytes, which only the stored form holds) and a lane cut short; every other lane
    final."""
    rng = np.random.default_rng(17)
    data = np.zeros((10, chunk), np.uint8)
    n = np.zeros(10, np.int32)
    for mode in range(8):
        raw = corpus(mode, chunk - 11 * mode)
        data[mode, : len(raw)] = np.frombuffer(raw, np.uint8)
        n[mode] = len(raw)
    data[8, :64] = np.frombuffer(corpus(0, 64), np.uint8)
    data[8, 64:] = rng.integers(0, 256, chunk - 64)
    n[8] = chunk
    data[9, :100] = np.frombuffer(corpus(1, 100), np.uint8)
    n[9] = 100
    finals = np.arange(10) % 2 == 1
    return data, n, finals


@pytest.mark.parametrize("chunk,window,max_match", [
    (4096, 256, 10), (8192, 256, 10), (4096, 32, 5),
    (4096, 256, 24),  # values up to 31 bits: three pack channels
])
def test_encode_blocks_batch_equal(chunk, window, max_match):
    fields = dict(chunk_size=chunk, window=window, max_match=max_match)
    data, n, finals = _lanes(chunk)
    out, lens, ntok = encode_blocks_batch(
        torch.from_numpy(data), torch.from_numpy(n), torch.from_numpy(finals),
        TConfig(**fields),
    )
    jout, jlens, jntok = j_encode(
        jnp.asarray(data), jnp.asarray(n), jnp.asarray(finals), JConfig(**fields)
    )
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(ntok.numpy(), np.asarray(jntok))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # lanes are self-contained static / stored block runs
    for b in range(len(n)):
        body = out[b, : lens[b]].numpy().tobytes()
        if finals[b]:
            assert zlib.decompress(body, -15) == data[b, : n[b]].tobytes()
    assert lens[8] == chunk + 5  # the random tail forces the stored form


@pytest.mark.parametrize("extra", [{"window": 32768}, {"lazy": True}])
def test_unported_encoder_options_raise(extra):
    """The options the port once refused with NotImplementedError (the
    full window, the lazy parse) now give the JAX package's bytes,
    lengths and token counts on every lane."""
    fields = {**dataclasses.asdict(TConfig()), "chunk_size": 4096, **extra}
    data, n, finals = _lanes(4096)
    out, lens, ntok = encode_blocks_batch(
        torch.from_numpy(data), torch.from_numpy(n), torch.from_numpy(finals),
        TConfig(**fields))
    jout, jlens, jntok = j_encode(
        jnp.asarray(data), jnp.asarray(n), jnp.asarray(finals), JConfig(**fields))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(ntok.numpy(), np.asarray(jntok))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


CORPUS = pathlib.Path(__file__).resolve().parent / "data" / "corpus.bin.gz"


def _stream_input(name):
    rng = np.random.default_rng(1951)
    if name == "zeros":
        return bytes(5000)
    if name == "trits":  # seeded bytes from {0, 1, 2}: short matches everywhere
        return rng.integers(0, 3, 9000).astype(np.uint8).tobytes()
    if name == "runs":
        return corpus(6, 12000)
    return gzip.decompress(CORPUS.read_bytes())[:16000]


@pytest.mark.parametrize("name", ["zeros", "trits", "runs", "corpus"])
@pytest.mark.parametrize("dynamic", [False, True])
def test_compress_equal_max_match_48(dynamic, name):
    """The whole stream at window 256, max_match 48: a run of one index in
    the bit-pack is 47 entries (about 94 with dynamic trees).  Every input
    is one chunk of 16 KiB, so the JAX package compiles once a
    configuration."""
    fields = dict(chunk_size=1 << 14, window=256, max_match=48,
                  dynamic_encode=dynamic)
    data = _stream_input(name)
    got = t_compress(data, TConfig(**fields), device="cpu")
    assert got == j_compress(data, JConfig(**fields))
    assert zlib.decompress(got) == data
