"""The incremental API of tpu_deflate_torch against the JAX package's:
inflate_stream_step, StreamCompressor and StreamDecompressor, with the
same outputs a call and the same errors."""

from __future__ import annotations

import dataclasses
import gzip
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import tpu_deflate as tj  # noqa: E402
import tpu_deflate_torch as td  # noqa: E402
from tests.corpora import corpus  # noqa: E402
from tpu_deflate.ops import decode as JD  # noqa: E402
from tpu_deflate_torch import lanes as L  # noqa: E402
from tpu_deflate_torch.ops import decode as TD  # noqa: E402
from tpu_deflate_torch.spec import tables as T  # noqa: E402

CHUNK = 4096
FIELDS = dataclasses.asdict(tj.DeflateConfig(chunk_size=CHUNK))
JCFG, TCFG = tj.DeflateConfig(**FIELDS), td.DeflateConfig(**FIELDS)
TEXT = b"".join(corpus(m, 13000) for m in [1, 3, 0])
# lines like TEXT's first, further on: zlib -9 takes dynamic trees for
# them, and their matches may reach into a window of TEXT
STEP_TEXT = b"".join(b"Hello world line %d!\n" % i for i in range(5000, 5110))


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
# inflate_stream_step
# ---------------------------------------------------------------------------


def _raw(payload, level, zdict=b"", strategy=zlib.Z_DEFAULT_STRATEGY,
         final=True):
    """Raw DEFLATE of payload whose distances may reach into zdict; not
    final: the block, then zlib's empty stored block of a sync flush."""
    kw = {"zdict": zdict} if zdict else {}
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy, **kw)
    return co.compress(payload) + co.flush(zlib.Z_FINISH if final else
                                           zlib.Z_SYNC_FLUSH)


def _static_block(tokens, final=1) -> bytes:
    """A static-tree block of tokens ("lit", byte) / ("match", length,
    distance), then its end-of-block."""
    lc = L.canonical(list(T.STATIC_LITLEN_LENGTHS))
    dc = L.canonical([5] * 30)
    f = [(final, 1), (1, 2)]
    for kind, a, *b in tokens:
        if kind == "lit":
            f.append(lc[a])
        else:
            i = int(np.searchsorted(T.LENGTH_BASE, a, "right")) - 1
            j = int(np.searchsorted(T.DIST_BASE, b[0], "right")) - 1
            f += [lc[257 + i], (a - int(T.LENGTH_BASE[i]), int(T.LENGTH_EXTRA_BITS[i])),
                  dc[j], (b[0] - int(T.DIST_BASE[j]), int(T.DIST_EXTRA_BITS[j]))]
    f.append(lc[256])
    return L.bits_to_bytes(f)


def _stored(payload: bytes, final=0) -> bytes:
    n = len(payload)
    return (bytes([final]) + n.to_bytes(2, "little")
            + (n ^ 0xFFFF).to_bytes(2, "little") + payload)


def _pending(kind: str, window: bytes) -> bytes:
    """The blocks of a step, byte-aligned, and what follows them."""
    text = STEP_TEXT
    if kind.startswith(("static", "dynamic")):
        fixed = kind.startswith("static")
        block = _raw(text, 6 if fixed else 9, window,
                     zlib.Z_FIXED if fixed else zlib.Z_DEFAULT_STRATEGY,
                     final=not kind.endswith("_sync"))
        assert (block[0] >> 1) & 3 == (1 if fixed else 2)
        # a sync flush's empty stored block follows a block that is not final
        return block + (b"\x05\x07" if kind.endswith("_sync") else b"")
    if kind == "stored_then_static":  # the walk passes a stored block
        return _stored(text[:300]) + _raw(text[300:], 6, window, zlib.Z_FIXED)
    assert kind == "stored_final"
    return _stored(text[:300], final=1) + b"\x13"


def _shift_in(data: bytes, pbit: int) -> bytes:
    """data after pbit bits that are already consumed, and followed by
    8 - pbit bits of the stream's next block (junk: ones, which no block
    ends on)."""
    junk = 0b1011011 & ((1 << pbit) - 1)
    n = (int.from_bytes(data, "little") << pbit) | junk
    if pbit:
        n |= ((1 << (8 - pbit)) - 1) << (8 * len(data) + pbit)
    return n.to_bytes(len(data) + (pbit > 0), "little")


def _inflate(block: bytes, window: bytes) -> bytes:
    return zlib.decompressobj(-15, zdict=window).decompress(block)


def _step_equal(window, pending, pbit, **kw):
    got = TD.inflate_stream_step(window, pending, pbit, device="cpu", **kw)
    want = JD.inflate_stream_step(window, pending, pbit, **kw)
    assert got == want
    return got


WINDOWS = {0: b"", 1: TEXT[:1], 32768: TEXT[:32768]}


@pytest.mark.parametrize("pbit", range(8))
@pytest.mark.parametrize("wlen", sorted(WINDOWS))
@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_stream_step_equal(kind, wlen, pbit):
    window = WINDOWS[wlen]
    block = _pending(kind, window)
    emitted, consumed, done = _step_equal(window, _shift_in(block, pbit), pbit)
    assert (emitted, done) == (_inflate(block, window), True)
    assert 8 * len(block) - 8 < consumed <= 8 * len(block)


@pytest.mark.parametrize("wlen", sorted(WINDOWS))
@pytest.mark.parametrize("kind", ["static_sync", "dynamic_sync",
                                  "stored_then_static", "stored_final"])
def test_stream_step_blocks_equal(kind, wlen):
    """A block that is not final and what follows it; stored blocks that
    the walk passes or ends at."""
    window = WINDOWS[wlen]
    emitted, consumed, done = _step_equal(window, _shift_in(
        _pending(kind, window), 3), 3)
    assert consumed > 0
    assert done == (kind in ("stored_then_static", "stored_final"))


@pytest.mark.parametrize("wlen", sorted(WINDOWS))
@pytest.mark.parametrize("kind", ["static", "dynamic", "stored_then_static"])
@pytest.mark.parametrize("cut", [2, 40, -3])
def test_stream_step_cut_short(kind, wlen, cut):
    """A block cut short (a header cut, a body cut, its last bytes gone):
    (b"", 0, False), so the caller feeds more and tries again."""
    window = WINDOWS[wlen]
    block = _pending(kind, window)
    assert _step_equal(window, _shift_in(block[:cut], 5), 5) == (b"", 0, False)


@pytest.mark.parametrize("wlen", [0, 32768])
def test_stream_step_long_output(wlen, monkeypatch):
    """A block whose output takes the row past 2^16 bytes: the window's
    stored token (empty at W = 0) is live, so the expansion takes the
    resolve route."""
    from tpu_deflate_torch.ops import expand as X

    calls = []
    resolve = X.resolve_roots
    monkeypatch.setattr(X, "resolve_roots",
                        lambda *a: calls.append(a) or resolve(*a))
    window = WINDOWS[wlen]
    text = b"".join(b"Hello world line %d!\n" % i for i in range(6000, 10000))
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zdict=window)
    block = co.compress(text) + co.flush()
    emitted, _consumed, done = _step_equal(window, _shift_in(block, 6), 6)
    assert wlen + len(emitted) > 1 << 16 and done
    assert emitted == _inflate(block, window)
    assert len(calls) == 1


def test_stream_step_stored_payload_cut():
    """A stored block whose payload is cut after its header: its end lies
    past the input, so the step waits."""
    block = _stored(TEXT[:300]) + _raw(TEXT[300:900], 6, b"", zlib.Z_FIXED)
    assert _step_equal(b"xyz", block[:100], 0) == (b"", 0, False)


@pytest.mark.parametrize("wlen", [0, 1])
@pytest.mark.parametrize("over", [0, 1])
@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_stream_step_distance_edge(kind, wlen, over):
    """A distance of exactly the window and the block's own output
    decodes; one byte more is an error, and the step waits.  The dynamic
    block's codes are complete: 226 literal/length codes of 8 bits and
    60 of 9, 2 distance codes of 4 bits and 28 of 5."""
    window = WINDOWS[wlen]
    tokens = [("lit", 66), ("match", 3, wlen + 1 + over)]
    block = (_static_block(tokens) if kind == "static" else
             L.hand_block([8] * 226 + [9] * 60, [4] * 2 + [5] * 28, tokens))
    got = _step_equal(window, block, 0)
    if over:
        assert got == (b"", 0, False)
    else:
        assert got[0] == _inflate(block, window) and got[2]


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_stream_step_static_only(kind):
    """Under static_only a static block decodes and a dynamic one raises
    the JAX package's DeflateError."""
    window = WINDOWS[1]
    pending = _shift_in(_pending(kind, window), 2)
    want = _raised(lambda: JD.inflate_stream_step(window, pending, 2, static_only=True)) \
        if kind == "dynamic" else None
    if kind == "dynamic":
        got = _raised(lambda: TD.inflate_stream_step(window, pending, 2,
                                                     static_only=True, device="cpu"))
        assert got == want and got[0] == "DeflateError"
    else:
        assert _step_equal(window, pending, 2, static_only=True)[2]


# ---------------------------------------------------------------------------
# StreamCompressor
# ---------------------------------------------------------------------------


def _feed(obj, method, data, cuts):
    """Per-call outputs of obj.method over data cut at cuts, then flush."""
    edges = [0, *cuts, len(data)]
    outs = [getattr(obj, method)(data[a:b]) for a, b in zip(edges, edges[1:])]
    return outs + [obj.flush()]


COMPRESS_FEEDS = {
    "empty": (b"", []),
    "two_chunks": (TEXT[: 2 * CHUNK], []),
    "two_chunks_split": (TEXT[: 2 * CHUNK], [CHUNK]),
    "ragged": (TEXT[:9001], [10, 5000, 5001, 8192]),
    "one_byte": (TEXT[:1], []),
}


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("feed", sorted(COMPRESS_FEEDS))
def test_stream_compressor_equal(feed, dynamic):
    data, cuts = COMPRESS_FEEDS[feed]
    fields = dict(FIELDS, dynamic_encode=dynamic)
    got = _feed(td.StreamCompressor(td.DeflateConfig(**fields), device="cpu"),
                "compress", data, cuts)
    want = _feed(tj.StreamCompressor(tj.DeflateConfig(**fields)), "compress",
                 data, cuts)
    assert got == want
    assert zlib.decompress(b"".join(got)) == data


def test_stream_compressor_after_flush():
    """A second flush and a compress after flush raise alike."""
    for call in ("flush", "compress"):
        objs = []
        for pkg in (td, tj):
            c = pkg.StreamCompressor(pkg.DeflateConfig(**FIELDS),
                                     **({"device": "cpu"} if pkg is td else {}))
            c.compress(TEXT[:100])
            c.flush()
            objs.append(c)
        args = () if call == "flush" else (b"x",)
        got, want = (_raised(lambda: getattr(o, call)(*args)) for o in objs)
        assert got == want == (ValueError, "stream already flushed")


# ---------------------------------------------------------------------------
# StreamDecompressor
# ---------------------------------------------------------------------------


def _members(data):
    return td.compress_gzip_members(data, TCFG, device="cpu")


def _small_blocks(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 1)
    return co.compress(data) + co.flush()


def _decompress_feed(name: str):
    """(stream, slice length) of a feed; made in the test, not while the
    module is imported."""
    data = TEXT[:30000]
    return {
        "members_1000": lambda: (_members(data), 1000),
        "members_whole": lambda: (_members(data), 10 ** 6),
        "zlib_own_500": lambda: (td.compress(data[:9000], TCFG, device="cpu"), 500),
        "zlib_6_4k": lambda: (zlib.compress(TEXT, 6), 4096),
        # memLevel 1: zlib ends a block every 128 symbols
        "zlib_6_small_blocks_300": lambda: (_small_blocks(TEXT[:6000]), 300),
        "zlib_0_700": lambda: (zlib.compress(TEXT[:20000], 0), 700),
        "zlib_1_3": lambda: (zlib.compress(TEXT[:500], 1), 3),
        "whole_gzip": lambda: (gzip.compress(data, 6), 5000),
        "whole_other": lambda: (b"\x00\x01\x02", 1),
    }[name]()


FEEDS = ["members_1000", "members_whole", "zlib_own_500", "zlib_6_4k",
         "zlib_6_small_blocks_300", "zlib_0_700", "zlib_1_3", "whole_gzip",
         "whole_other"]


@pytest.mark.parametrize("feed", FEEDS)
def test_stream_decompressor_equal(feed):
    """The same output a call as the JAX class, in all three modes."""
    stream, step = _decompress_feed(feed)
    cuts = list(range(step, len(stream), step))
    tdec = td.StreamDecompressor(TCFG, device="cpu")
    jdec = tj.StreamDecompressor(JCFG)
    if feed == "whole_other":  # not zlib, not gzip: decompress raises at flush
        got = [tdec.decompress(stream[a : a + 1]) for a in range(len(stream))]
        assert got == [jdec.decompress(stream[a : a + 1]) for a in range(len(stream))]
        assert _raised(tdec.flush) == _raised(jdec.flush)
        return
    got = _feed(tdec, "decompress", stream, cuts)
    want = _feed(jdec, "decompress", stream, cuts)
    assert got == want
    plain = gzip.decompress(stream) if stream[:2] == b"\x1f\x8b" else zlib.decompress(stream)
    assert b"".join(got) == plain
    if feed in ("members_1000", "zlib_own_500", "zlib_6_small_blocks_300"):
        assert any(got[:-2]), "no output before the last feed"


def _damaged(what):
    """(stream, feed cut) of a damaged stream."""
    data = TEXT[:9000]
    if what == "zlib_truncated":
        return td.compress(data, TCFG, device="cpu")[:-6], None
    if what == "zlib_trailer_cut":
        return td.compress(data, TCFG, device="cpu")[:-2], None
    if what == "zlib_bad_adler":
        s = bytearray(td.compress(data, TCFG, device="cpu"))
        s[-1] ^= 0xFF
        return bytes(s), None
    if what == "zlib6_truncated":
        return zlib.compress(TEXT[:13000], 6)[:-9], None
    if what == "member_truncated":
        return _members(data)[:-7], None
    if what == "member_bad_crc":
        g = bytearray(_members(data))
        g[int.from_bytes(g[16:20], "little") - 8] ^= 1
        return bytes(g), 1000
    if what == "not_members":
        g = bytearray(_members(data))
        end = int.from_bytes(g[16:20], "little")
        g[end + 12] ^= 1  # the second member's subfield id
        return bytes(g), None
    assert what == "stored_len"
    s = bytearray(zlib.compress(data, 0))
    s[5] ^= 1  # the first stored block's NLEN
    return bytes(s), None


@pytest.mark.parametrize("what", [
    "zlib_truncated", "zlib_trailer_cut", "zlib_bad_adler", "zlib6_truncated",
    "member_truncated", "member_bad_crc", "not_members", "stored_len",
])
def test_stream_decompressor_errors_alike(what):
    stream, step = _damaged(what)
    cuts = [] if step is None else list(range(step, len(stream), step))

    def run(dec):
        return lambda: _feed(dec, "decompress", stream, cuts)

    got = _raised(run(td.StreamDecompressor(TCFG, device="cpu")))
    want = _raised(run(tj.StreamDecompressor(JCFG)))
    assert got == want
    assert got[0] is ValueError


def test_stream_decompressor_after_flush():
    for call in ("flush", "decompress"):
        objs = []
        for pkg in (td, tj):
            d = pkg.StreamDecompressor(pkg.DeflateConfig(**FIELDS),
                                       **({"device": "cpu"} if pkg is td else {}))
            d.decompress(zlib.compress(b"abc"))
            d.flush()
            objs.append(d)
        args = () if call == "flush" else (b"x",)
        got, want = (_raised(lambda: getattr(o, call)(*args)) for o in objs)
        assert got == want == (ValueError, "stream already finished")
