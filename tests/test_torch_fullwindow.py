"""tpu_deflate_torch's full-window encode (window to 32768, max_match 258,
lazy, both far matchers) against the JAX package's on the CPU: the
matchers' (dist, length), the batch encoder's bytes, lengths and token
counts, and the API's streams, all exactly equal.

JAX compiles each configuration once a process (a few seconds); the
lanes are shared by every test, so each configuration compiles once."""

from __future__ import annotations

import functools
import gzip
import pathlib
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_deflate.api as JA  # noqa: E402
import tpu_deflate.ops.encode as JE  # noqa: E402
import tpu_deflate_torch as td  # noqa: E402
import tpu_deflate_torch.ops.encode as TE  # noqa: E402
from tpu_deflate.config import DeflateConfig as JConfig  # noqa: E402
from tpu_deflate_torch.config import DeflateConfig as TConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops here: the lanes are
    small, and under parallel test workers more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CORPUS = pathlib.Path(__file__).resolve().parent / "data" / "corpus.bin.gz"
N = 4096
FAR_N = 32768


@functools.lru_cache(maxsize=None)
def _raw() -> bytes:
    return gzip.decompress(CORPUS.read_bytes())[: 1 << 17]


def _repeats(rng, size: int, backs) -> np.ndarray:
    """Seeded random bytes in which a block of 200 recurs ``back`` bytes
    after its first copy, for each back, so the nearest match is that far."""
    x = rng.integers(0, 256, size).astype(np.uint8)
    for k, back in enumerate(backs):
        at = 64 + 250 * k
        x[at + back : at + back + 200] = x[at : at + 200]
    return x


@functools.lru_cache(maxsize=None)
def _lanes():
    """Four lanes of 4096: a corpus slice, seeded trits cut short, zeros
    cut to 1000, and seeded random bytes with a block repeated 300 back;
    (data, n, finals)."""
    rng = np.random.default_rng(1951)
    data = np.zeros((4, N), np.uint8)
    data[0] = np.frombuffer(_raw()[:N], np.uint8)
    data[1] = rng.integers(0, 3, N)
    data[3] = _repeats(rng, N, [300, 1000])
    n = np.array([N, N - 5, 1000, N], np.int32)
    return data, n, np.array([False, True, False, True])


@functools.lru_cache(maxsize=None)
def _far_lanes():
    """Two lanes of 32768: seeded random bytes with blocks repeated 300,
    5000 and 30000 back, and a corpus slice cut to 31000."""
    rng = np.random.default_rng(1952)
    data = np.zeros((2, FAR_N), np.uint8)
    data[0] = _repeats(rng, FAR_N, [300, 5000, 30000])
    data[1] = np.frombuffer(_raw()[40000 : 40000 + FAR_N], np.uint8)
    return data, np.array([FAR_N, 31000], np.int32), np.array([False, True])


@functools.lru_cache(maxsize=None)
def _jax_encode(lanes: str, fields: tuple):
    data, n, finals = {"near": _lanes, "far": _far_lanes}[lanes]()
    out = JE.encode_blocks_batch(jnp.asarray(data), jnp.asarray(n),
                                 jnp.asarray(finals), JConfig(**dict(fields)))
    return tuple(np.asarray(x) for x in out)


def _check_encode(lanes: str, **fields):
    data, n, finals = {"near": _lanes, "far": _far_lanes}[lanes]()
    fields.setdefault("chunk_size", data.shape[1])
    jout, jlens, jntok = _jax_encode(lanes, tuple(sorted(fields.items())))
    out, lens, ntok = TE.encode_blocks_batch(
        torch.from_numpy(data), torch.from_numpy(n), torch.from_numpy(finals),
        TConfig(**fields))
    np.testing.assert_array_equal(lens.numpy(), jlens)
    np.testing.assert_array_equal(ntok.numpy(), jntok)
    np.testing.assert_array_equal(out.numpy(), jout)
    for b in range(len(n)):  # each lane is a block run that zlib reads
        body = out[b, : lens[b]].numpy().tobytes()
        got = zlib.decompressobj(-15).decompress(body)
        assert got == data[b, : n[b]].tobytes(), b
    return out, lens


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("matcher", ["exact", "fast"])
def test_full_window_encode_equal(matcher, dynamic, lazy):
    _check_encode("near", window=32768, max_match=258, far_matcher=matcher,
                  dynamic_encode=dynamic, lazy=lazy)


@pytest.mark.parametrize("max_match", [10, 18])
@pytest.mark.parametrize("window", [300, 1024])
def test_mid_window_static_width_equal(window, max_match):
    """Static emissions past window 256 take 31 bits: at window 1024 and
    max_match 10 a distance's 8 extra bits and a length code overflow 20."""
    _check_encode("near", window=window, max_match=max_match)
    assert TE._emission_bits(TConfig(window=window, max_match=max_match)) == 31


def test_lazy_at_window_256_equal():
    """The lazy deferral over the match2 kernel's lengths."""
    _check_encode("near", window=256, max_match=10, lazy=True)


@pytest.mark.parametrize("matcher", ["exact", "fast"])
def test_far_distances_encode_equal(matcher):
    """Lanes of 32768 with matches 5000 and 30000 back."""
    out, lens = _check_encode("far", window=32768, max_match=258,
                              far_matcher=matcher, dynamic_encode=True, lazy=True)
    assert lens[0] < 0.99 * FAR_N  # the repeats were found


@functools.lru_cache(maxsize=None)
def _jax_match(matcher: str, max_match: int):
    data, n, _ = _far_lanes()
    fn = {"exact": JE._match_candidates_multi, "fast": JE._match_candidates_fast}[matcher]

    def lane(d, nn):
        b = d.astype(jnp.int32)
        idx = jnp.arange(b.shape[0], dtype=jnp.int32)
        b1 = jnp.concatenate([b[1:], jnp.zeros((1,), jnp.int32)])
        b2 = jnp.concatenate([b[2:], jnp.zeros((2,), jnp.int32)])
        key3 = b | (b1 << 8) | (b2 << 16)
        key3 = jnp.where(idx + 3 <= nn, key3, (1 << 24) + idx)
        return fn(b, key3, nn, 32768, max_match)

    dist, length = jax.jit(jax.vmap(lane))(jnp.asarray(data), jnp.asarray(n))
    return np.asarray(dist), np.asarray(length)


@pytest.mark.parametrize("max_match", [258, 12])
@pytest.mark.parametrize("matcher", ["exact", "fast"])
def test_far_matcher_equal(matcher, max_match):
    """The matchers alone: (dist, length) at every position."""
    data, n, _ = _far_lanes()
    b = torch.from_numpy(data).to(torch.int64)
    n64 = torch.from_numpy(n).to(torch.int64)[:, None]
    fn = {"exact": TE._match_candidates_multi, "fast": TE._match_candidates_fast}[matcher]
    dist, length = fn(b, TE._key3(b, n64), n64, 32768, max_match)
    jdist, jlength = _jax_match(matcher, max_match)
    np.testing.assert_array_equal(length.numpy(), jlength)
    np.testing.assert_array_equal(dist.numpy(), jdist)
    far = (length.numpy() >= 3) & (dist.numpy() > 4096)
    assert far.any()  # distances past the near lanes' reach


def test_prev_occurrence_equal():
    rng = np.random.default_rng(3)
    keys = rng.integers(-5, 40, (3, 500)).astype(np.int32)
    got = TE._prev_occurrence(torch.from_numpy(keys).to(torch.int64))
    want = jax.vmap(JE._prev_occurrence)(jnp.asarray(keys))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _input(size: int) -> bytes:
    rng = np.random.default_rng(7)
    block = rng.integers(0, 256, 700).astype(np.uint8).tobytes()
    return _raw()[:size - 1400] + block + _raw()[5000:5300] + block[:1100]


@functools.lru_cache(maxsize=None)
def _jax_indexed(chunk: int):
    cfg = JConfig(**{**td.FULL_WINDOW.__dict__, "chunk_size": chunk})
    stream, index = JA.compress_indexed(_input(4 * 4096), cfg)
    return stream, np.asarray(index)


@pytest.mark.parametrize("chunk", [4096, 8192])
def test_full_window_indexed_round_trip(chunk):
    """compress_indexed of both packages equal; the port's
    decompress_indexed and decompress return the input, as the JAX
    package's decompress does."""
    data = _input(4 * 4096)
    cfg = TConfig(**{**td.FULL_WINDOW.__dict__, "chunk_size": chunk})
    stream, index = td.compress_indexed(data, cfg, device="cpu")
    jstream, jindex = _jax_indexed(chunk)
    assert stream == jstream
    np.testing.assert_array_equal(index, jindex)
    assert zlib.decompress(stream) == data
    assert td.decompress_indexed(stream, index, cfg, device="cpu") == data
    assert td.decompress(stream, device="cpu") == data
    assert JA.decompress(stream) == data


def test_full_window_api_equal():
    """compress, compress_gzip, compress_gzip_members and StreamCompressor
    with FULL_WINDOW at 4096-byte chunks: the JAX package's bytes."""
    data = _input(4 * 4096)
    fields = {**td.FULL_WINDOW.__dict__, "chunk_size": 4096}
    cfg, jcfg = TConfig(**fields), JConfig(**fields)
    assert td.compress(data, cfg, device="cpu") == _jax_indexed(4096)[0]
    g = td.compress_gzip(data, cfg, device="cpu")
    assert g == JA.compress_gzip(data, jcfg) and gzip.decompress(g) == data
    m = td.compress_gzip_members(data, cfg, device="cpu")
    assert m == JA.compress_gzip_members(data, jcfg) and gzip.decompress(m) == data
    assert td.decompress_gzip(m, cfg, device="cpu") == data
    parts = [data[i : i + 5000] for i in range(0, len(data), 5000)]
    sc, jsc = td.StreamCompressor(cfg, device="cpu"), JA.StreamCompressor(jcfg)
    for p in parts:
        assert sc.compress(p) == jsc.compress(p)
    tail = sc.flush()
    assert tail == jsc.flush()
