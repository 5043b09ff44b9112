"""tpu_deflate_torch's sharding layer against the JAX package's on the CPU:
a mesh of eight ``cpu`` entries beside the eight virtual devices of
``tests/conftest.py``.  The sharded encode's bytes, sizes and Adler-32,
the sharded decode's bytes, totals and errors on every lane (padding,
damaged and bit-shifted lanes included), the ragged assembly, the Adler
fold and the single-lane encoder are all exactly equal; the multi-process
functions degenerate on one process as the JAX package's do."""

from __future__ import annotations

import functools
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_deflate.ops.encode as JE  # noqa: E402
import tpu_deflate.parallel.shard as JS  # noqa: E402
import tpu_deflate_torch.ops.encode as TE  # noqa: E402
import tpu_deflate_torch.parallel.shard as TS  # noqa: E402
from tests.corpora import corpus  # noqa: E402
from tpu_deflate.config import DeflateConfig as JConfig  # noqa: E402
from tpu_deflate.parallel import multihost as JM  # noqa: E402
from tpu_deflate_torch import dryrun  # noqa: E402
from tpu_deflate_torch.config import DeflateConfig as TConfig  # noqa: E402
from tpu_deflate_torch.parallel import multihost as TM  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops here: the lanes are
    small, and under parallel test workers more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D = 8  # devices in either mesh
STATIC = dict(window=256, max_match=10, chunk_size=2048)
DYNAMIC = dict(STATIC, dynamic_encode=True)


@functools.lru_cache(maxsize=None)
def _meshes():
    return JS.make_mesh(), TS.make_mesh(["cpu"] * D)


def _chunk_batch(data: bytes, chunk: int, multiple: int):
    """tests/test_parallel.py's batch: zero-padded chunks, lengths, the
    last live chunk final, rows padded to a multiple of the mesh."""
    n = len(data)
    nchunks = max(1, -(-n // chunk))
    b = -(-nchunks // multiple) * multiple
    arr = np.zeros((b, chunk), np.uint8)
    flat = np.frombuffer(data, np.uint8)
    for i in range(nchunks):
        part = flat[i * chunk : (i + 1) * chunk]
        arr[i, : len(part)] = part
    lens = np.clip(n - np.arange(b) * chunk, 0, chunk).astype(np.int32)
    finals = np.zeros(b, bool)
    finals[nchunks - 1] = True
    return arr, lens, finals, nchunks


# the corpora of tests/test_parallel.py: its encode, Adler and assembly tests
CORPORA = {
    "modes_0123": lambda: b"".join(corpus(m, 4000) for m in [0, 1, 2, 3]),
    "mode2_30000": lambda: corpus(2, 30000),
    "modes_1246": lambda: b"".join(corpus(m, 3000) for m in [1, 2, 4, 6]),
}


def _stream(out, sizes, adler, nchunks: int) -> bytes:
    out, sizes = np.asarray(out)[:nchunks], np.asarray(sizes)[:nchunks]
    body = b"".join(out[i, : sizes[i]].tobytes() for i in range(nchunks))
    return b"\x78\x9c" + body + int(adler).to_bytes(4, "big")


@functools.lru_cache(maxsize=None)
def _all_corpora():
    """The three corpora's batches one after another, 32 rows of 2048
    (each corpus's last live chunk final), and each corpus's first row."""
    parts = [_chunk_batch(CORPORA[k](), 2048, D) for k in sorted(CORPORA)]
    rows = np.cumsum([0] + [p[0].shape[0] for p in parts])
    return (*(np.concatenate([p[i] for p in parts]) for i in range(3)),
            dict(zip(sorted(CORPORA), rows[:-1])))


@pytest.mark.parametrize("trees", ["static", "dynamic"])
def test_encode_sharded_equal(trees):
    """All three corpora in one batch (one JAX program a configuration):
    bytes, sizes and Adler-32 equal to the JAX package's."""
    jmesh, tmesh = _meshes()
    kw = STATIC if trees == "static" else DYNAMIC
    arr, lens, finals, _ = _all_corpora()
    jout, jsizes, jadler = JS.encode_sharded(
        jnp.asarray(arr), jnp.asarray(lens), jnp.asarray(finals), jmesh,
        JConfig(**kw))
    tout, tsizes, tadler = TS.encode_sharded(arr, lens, finals, tmesh, TConfig(**kw))
    assert tout.shape == jout.shape and tout.dtype == torch.uint8
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tsizes.numpy(), np.asarray(jsizes))
    assert int(tadler) == int(jadler)
    assert int(tadler) == zlib.adler32(b"".join(
        arr[i, : lens[i]].tobytes() for i in range(len(lens))))


@pytest.mark.parametrize("trees", ["static", "dynamic"])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_encode_sharded_corpus(name, trees):
    """Each corpus alone, as tests/test_parallel.py encodes it: its rows of
    the batch above, a stream zlib reads, its Adler-32, and the same body
    from the ragged assembly on the device."""
    kw = STATIC if trees == "static" else DYNAMIC
    data = CORPORA[name]()
    arr, lens, finals, nchunks = _chunk_batch(data, 2048, D)
    out, sizes, adler = TS.encode_sharded(arr, lens, finals, _meshes()[1], TConfig(**kw))
    first = _all_corpora()[3][name]
    whole = TS.encode_sharded(*_all_corpora()[:3], _meshes()[1], TConfig(**kw))
    assert torch.equal(out, whole[0][first : first + len(lens)])
    assert int(adler) == zlib.adler32(data)
    stream = _stream(out, sizes, adler, nchunks)
    assert zlib.decompress(stream) == data
    sizes = torch.where(torch.arange(sizes.shape[0]) < nchunks, sizes, 0)
    body, total = TS.assemble_ragged(out, sizes, out.numel())
    assert body[: int(total)].numpy().tobytes() == stream[2:-4]


def test_adler_fold_32k_chunks_equal_to_zlib():
    """tests/test_parallel.py's regression: bytes 128-255 drive a high at
    every 32 KiB chunk boundary, where rem * (a1 - 1) passes 2^31."""
    rng = np.random.default_rng(65521)
    data = rng.integers(128, 256, 4 * 32768, np.uint8).tobytes()
    arr, lens, finals, nchunks = _chunk_batch(data, 32768, D)
    cfg = TConfig(window=256, max_match=10, chunk_size=32768)
    out, sizes, adler = TS.encode_sharded(arr, lens, finals, _meshes()[1], cfg)
    assert int(adler) == zlib.adler32(data)
    assert zlib.decompress(_stream(out, sizes, adler, nchunks)) == data


@pytest.mark.parametrize("n", [1, 5, 8, 13])
def test_adler_fold_equal(n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 65521, n).astype(np.int32)
    b = rng.integers(0, 65521, n).astype(np.int32)
    lens = rng.integers(0, 32769, n).astype(np.int32)
    a[0], lens[-1] = 65520, 32768  # the largest state and chunk
    want = JS._adler_fold(jnp.asarray(a), jnp.asarray(b), jnp.asarray(lens))
    got = TS._adler_fold(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(lens))
    assert [int(x) for x in got] == [int(x) for x in want]


@pytest.mark.parametrize("zero_lanes", [False, True])
def test_assemble_ragged_equal(zero_lanes):
    rng = np.random.default_rng(7)
    chunks = rng.integers(0, 256, (8, 96), np.uint8)
    sizes = rng.integers(0, 97, 8).astype(np.int32)
    if zero_lanes:
        sizes[[0, 3, 7]] = 0
    cap = 8 * 96
    jbody, jtotal = jax.jit(JS.assemble_ragged, static_argnames="total_cap")(
        jnp.asarray(chunks), jnp.asarray(sizes), total_cap=cap)
    tbody, ttotal = TS.assemble_ragged(torch.as_tensor(chunks), torch.as_tensor(sizes), cap)
    np.testing.assert_array_equal(tbody.numpy(), np.asarray(jbody))
    assert int(ttotal) == int(jtotal) == int(sizes.sum())


# ---- the sharded decode ---------------------------------------------------


def _bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")


def _raw_deflate(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(payload) + co.flush()


@functools.lru_cache(maxsize=None)
def _decode_case():
    """(stream uint8[2^k], start bits, end bits, lane names, data, chunks)
    of 32 lanes: the 8 chunks of a static body; the same 8 in a copy of the
    body that starts 3 bits into a byte; then damaged and edge lanes, and
    padding lanes (start == end at the body's end) as tests/
    test_parallel.py pads its batch."""
    data = CORPORA["modes_0123"]()
    arr, lens, finals, nchunks = _chunk_batch(data, 2048, D)
    out, sizes, _ = TS.encode_sharded(arr, lens, finals, _meshes()[1], TConfig(**STATIC))
    out, sizes = out.numpy()[:nchunks], sizes.numpy()[:nchunks]
    chunks = [out[i, : sizes[i]].tobytes() for i in range(nchunks)]
    body = b"".join(chunks)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    text = data[5000:9000]
    bad = bytearray(chunks[2])
    for i in range(40, len(bad), 97):
        bad[i] ^= 0x5A
    extra = {"corrupt": bytes(bad), "dynamic": _raw_deflate(text, 9),
             "stored": _raw_deflate(text[:900], 0),
             "stored_cut": _raw_deflate(text[:900], 0)[:7]}
    bits = [_bits(body), np.zeros(3, np.uint8), _bits(body)]
    shift = len(bits[0]) + 3
    pos = shift + len(bits[2])
    bits.append(np.zeros((-pos) % 8, np.uint8))
    pos += (-pos) % 8
    at = {}
    for k, e in extra.items():
        at[k] = (pos, pos + 8 * len(e))
        bits.append(_bits(e))
        pos += 8 * len(e)
    at["stored_cut"] = (at["stored_cut"][0], pos)
    stream = np.packbits(np.concatenate(bits), bitorder="little")
    buf = np.zeros(1 << int(np.ceil(np.log2(len(stream) + 1))), np.uint8)
    buf[: len(stream)] = stream
    s0, e0 = 8 * offs[:-1], 8 * offs[1:]
    lanes = [(f"chunk{i}", s0[i], e0[i]) for i in range(nchunks)]
    lanes += [(f"shifted{i}", s0[i] + shift, e0[i] + shift) for i in range(nchunks)]
    lanes += [
        ("cut_mid_block", s0[0], s0[0] + 8 * sizes[0] // 2),
        ("start_mid_block", s0[1] + 8 * sizes[1] // 2 + 5, e0[1]),
        ("shifted_cut", s0[3] + shift, s0[3] + shift + 8 * sizes[3] // 2),
        *((k, *at[k]) for k in extra),
        ("two_bits", e0[-1] - 2, e0[-1]),
        ("last_bit", 8 * len(buf) - 1, 8 * len(buf)),
        ("stream_end", 8 * len(buf), 8 * len(buf)),
        ("end_before_start", s0[4], s0[4] - 40),
    ]
    lanes += [("pad", e0[-1], e0[-1])] * (32 - len(lanes))
    names, starts, ends = zip(*lanes)
    return (buf, np.asarray(starts, np.int32), np.asarray(ends, np.int32),
            names, data, chunks)


@pytest.mark.parametrize("static_only", [True, False])
def test_decode_sharded_equal_every_lane(static_only):
    jmesh, tmesh = _meshes()
    buf, starts, ends, names, data, chunks = _decode_case()
    want = JS.decode_sharded(jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(ends),
                             jmesh, chunk_out_size=2048, static_only=static_only)
    got = TS.decode_sharded(buf, starts, ends, tmesh, chunk_out_size=2048,
                            static_only=static_only)
    for g, w, what in zip(got, want, ("out", "totals", "errs")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    out, totals, errs = (g.numpy() for g in got)
    err = dict(zip(names, errs))
    n = len(chunks)
    assert (errs[:n] == 0).all()
    assert b"".join(out[i, : totals[i]].tobytes() for i in range(n)) == data
    # 3 bits on, the Huffman chunks decode as before; a stored chunk's
    # payload starts at a byte boundary, which now lies elsewhere
    for i in range(n):
        stored = (chunks[i][0] >> 1) & 3 == 0
        assert (errs[n + i] == 0) != stored
        if not stored:
            assert out[n + i, : totals[n + i]].tobytes() == out[i, : totals[i]].tobytes()
    assert err["cut_mid_block"] != 0 and err["shifted_cut"] != 0
    assert (err["dynamic"] != 0) == static_only and err["stored"] == 0
    for k in ("stream_end", "end_before_start", "pad"):
        assert err[k] == 0 and totals[names.index(k)] == 0


def test_decode_sharded_stored_copy_past_an_unpadded_stream():
    """A stored block whose LEN runs past the end of a stream that ends in
    a nonzero byte: the JAX lanes report no error and copy the stream's
    last byte from there on (a clamped gather).  Each device's second lane
    starts at that block, so its rows reach past the stream, where the
    tokenizer reads zeros and the copy must read the last byte."""
    jmesh, tmesh = _meshes()
    head = bytes([0, 200, 0, 0xFF - 200, 0xFF]) + bytes(range(200))
    tail = bytes([1, 100, 0, 0xFF - 100, 0xFF]) + bytes(range(0xA2, 0xAC))
    buf = np.frombuffer(head + tail, np.uint8)
    starts = np.zeros(2 * D, np.int32)
    starts[1::2] = 8 * len(head)
    ends = np.full(2 * D, 8 * len(buf), np.int32)
    want = JS.decode_sharded(jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(ends),
                             jmesh, chunk_out_size=256)
    got = TS.decode_sharded(buf, starts, ends, tmesh, chunk_out_size=256)
    for g, w, what in zip(got, want, ("out", "totals", "errs")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    out, totals, errs = (g.numpy() for g in got)
    assert (errs == 0).all() and (totals[1::2] == 100).all()
    assert (out[1::2, 10:100] == 0xAB).all()


def test_decode_sharded_refuses_bits_outside_the_stream():
    buf, starts, ends, *_ = _decode_case()
    mesh = _meshes()[1]
    for s, e in ((starts, np.where(ends == ends.max(), 8 * len(buf) + 8, ends)),
                 (np.where(starts == starts.min(), -1, starts), ends)):
        with pytest.raises(ValueError):
            TS.decode_sharded(buf, s, e, mesh, chunk_out_size=2048)


@pytest.mark.parametrize("which", ["encode", "decode"])
def test_batch_that_does_not_divide_raises_the_jax_type(which):
    jmesh, tmesh = _meshes()
    cfg = dict(window=256, max_match=10, chunk_size=256)
    arr, lens, fin = np.zeros((6, 256), np.uint8), np.full(6, 256, np.int32), np.zeros(6, bool)
    bits, buf = np.zeros(6, np.int32), np.zeros(64, np.uint8)
    if which == "encode":
        with pytest.raises(ValueError) as jerr:
            JS.encode_sharded(jnp.asarray(arr), jnp.asarray(lens), jnp.asarray(fin),
                              jmesh, JConfig(**cfg))
        with pytest.raises(jerr.type):
            TS.encode_sharded(arr, lens, fin, tmesh, TConfig(**cfg))
    else:
        with pytest.raises(ValueError) as jerr:
            JS.decode_sharded(jnp.asarray(buf), jnp.asarray(bits), jnp.asarray(bits),
                              jmesh, 256)
        with pytest.raises(jerr.type):
            TS.decode_sharded(buf, bits, bits, tmesh, 256)


# ---- one process ----------------------------------------------------------


def test_multihost_degenerates_on_one_process():
    assert TM.initialize(device="cpu") is JM.initialize() is False
    assert TM.host_shard_bounds(16) == JM.host_shard_bounds(16) == (0, 16)
    assert TM.host_shard_bounds(5) == JM.host_shard_bounds(5)


def test_make_mesh_needs_a_card():
    if torch.cuda.is_available():
        assert {d.type for d in TS.make_mesh().devices} == {"cuda"}
    else:
        with pytest.raises(RuntimeError):
            TS.make_mesh()
        with pytest.raises(RuntimeError):
            TM.global_mesh()


def test_make_global_batch_encode_equal():
    """tests/test_parallel.py's make_global_batch case: the rows put on
    the mesh's devices encode as the global batch does."""
    mesh = TS.make_mesh(["cpu"] * D)
    assert mesh.size == D and mesh.group is None
    data = b"".join(corpus(m, 2000) for m in [0, 1])
    arr, lens, finals, nchunks = _chunk_batch(data, 1024, D)
    cfg = TConfig(window=256, max_match=10, chunk_size=1024)
    garr = TM.make_global_batch(arr, arr.shape[0], mesh)
    assert garr.shape == arr.shape and len(garr.shards) == D
    out, sizes, adler = TS.encode_sharded(garr, lens, finals, mesh, cfg)
    want = TS.encode_sharded(arr, lens, finals, mesh, cfg)
    assert all(torch.equal(x, y) for x, y in zip((out, sizes, adler), want))
    assert zlib.decompress(_stream(out, sizes, adler, nchunks)) == data


# ---- the single-lane encoder ----------------------------------------------

BLOCK_N = 4096
BLOCK_CASES = {  # greedy with static trees; lazy with dynamic trees
    "static": dict(window=256, max_match=10),
    "dynamic_lazy": dict(window=256, max_match=10, dynamic_encode=True, lazy=True),
}


@functools.lru_cache(maxsize=None)
def _block_lanes():
    """(data uint8[N], n, final) lanes: text, seeded random bytes (stored),
    a lane cut short, an empty lane, long runs."""
    text = b"".join(corpus(m, 1300) for m in [0, 1, 2])
    lanes = []
    for payload, final in ((text, True), (corpus(3, BLOCK_N), False),
                           (text[:1000], False), (b"", True),
                           (corpus(6, BLOCK_N), True)):
        x = np.zeros(BLOCK_N, np.uint8)
        x[: len(payload)] = np.frombuffer(payload, np.uint8)
        lanes.append((x, len(payload), final))
    return lanes


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_encode_block_bits_equal(case):
    kw = BLOCK_CASES[case]
    for x, n, final in _block_lanes():
        want = JE.encode_block_bits(jnp.asarray(x), jnp.int32(n), jnp.bool_(final),
                                    use_sort_matcher=False, **kw)
        got = TE.encode_block_bits(torch.as_tensor(x), n, final,
                                   use_sort_matcher=False, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # and the config-driven wrapper takes the same route
        via = TE.encode_block(torch.as_tensor(x), n, final, TConfig(**kw))
        assert all(torch.equal(g, v) for g, v in zip(got, via))
        out, ln = got[0].numpy(), int(got[1])
        stream = out[:ln].tobytes()
        tail = b"" if final else b"\x03\x00"  # close a non-final lane
        assert zlib.decompressobj(-15).decompress(stream + tail) == x[:n].tobytes()


def test_encode_block_full_window_equal_to_batch_lane():
    """At window 32768 the single-lane encoder takes the far matcher: each
    lane equals the batch encoder's, which tests/test_torch_fullwindow.py
    holds to the JAX package."""
    for matcher in ("exact", "fast"):
        cfg = TConfig(window=32768, max_match=258, lazy=True,
                      dynamic_encode=matcher == "exact", far_matcher=matcher)
        lanes = _block_lanes()
        arr = torch.as_tensor(np.stack([x for x, _, _ in lanes]))
        lens = torch.tensor([n for _, n, _ in lanes], dtype=torch.int32)
        fins = torch.tensor([f for _, _, f in lanes])
        batch = TE.encode_blocks_batch(arr, lens, fins, cfg)
        for i, (x, n, final) in enumerate(lanes):
            got = TE.encode_block(torch.as_tensor(x), n, final, cfg)
            for g, b in zip(got, batch):
                assert torch.equal(g, b[i])


def test_dryrun_entry_equal_to_jax_lanes():
    fn, args = dryrun.entry(device="cpu")
    out, sizes, ntok = fn(*args)
    data, lengths, finals = (a.numpy() for a in args)
    assert out.shape == (4, TE.max_output_bytes(4096)) and bool(finals[-1])
    for i in range(4):
        want = JE.encode_block_bits(jnp.asarray(data[i]), jnp.int32(lengths[i]),
                                    jnp.bool_(finals[i]), window=256, max_match=10,
                                    use_sort_matcher=False)
        for g, w in zip((out[i], sizes[i], ntok[i]), want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_devices", [1, 2])
def test_dryrun_multichip_cpu(n_devices, capsys):
    dryrun.dryrun_multichip(n_devices, device="cpu")
    assert f"dryrun_multichip ok: {n_devices} devices" in capsys.readouterr().out
