"""The port's spans on its decode paths, on the CPU: one root a
``decompress`` or ``decompress_indexed`` call with its copies, checksum
and two decode stages inside it; the device-paced walk's counts against
the Huffman blocks the plain inflater reads; and nothing recorded, at the
cost of a flag test, without a profiler."""

import gzip
import pathlib
import zlib

import pytest
from torch.profiler import ProfilerActivity, profile

import tpu_deflate_torch as td
import tpu_deflate_torch.ref.inflate as RI
from tpu_deflate_torch.ops.foreign import inflate_foreign_device
from tpu_deflate_torch.utils import profiling

CORPUS = pathlib.Path(__file__).resolve().parent / "data" / "corpus.bin.gz"
DATA = (b"spans on the decode path, " * 40 + bytes(range(256)) * 8) * 5
FW = td.DeflateConfig(**{**td.FULL_WINDOW.__dict__, "chunk_size": 4096})
STAGES = ["td.decode.tokenize", "td.decode.expand"]


def _traced(fn, *args, **kwargs):
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn(*args, **kwargs)
    return out, profiling.spans()


def _decompress():
    return td.decompress(zlib.compress(DATA, 6), device="cpu")


def _decompress_indexed():
    stream, index = td.compress_indexed(DATA, FW, device="cpu")
    profiling.clear()  # the compress call's spans
    return td.decompress_indexed(stream, index, FW, device="cpu")


CALLS = {"td.api.decompress": _decompress, "td.api.decompress_indexed": _decompress_indexed}


@pytest.mark.parametrize("root_name", sorted(CALLS))
def test_one_root_a_call_and_children_inside_it(root_name):
    out, spans = _traced(CALLS[root_name])
    assert out == DATA and out == CALLS[root_name]()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == root_name
    kids = sorted((s for s in spans if s is not root), key=lambda s: s.t0_ns)
    assert [s.name for s in kids if s.name in STAGES] == STAGES
    assert {"td.api.h2d", "td.api.d2h", "td.checksum.adler"} <= {s.name for s in kids}
    for s in kids:
        assert s.parent == root.id == s.root  # each a child of the root
        assert root.t0_ns <= s.t0_ns <= s.t1_ns <= root.t1_ns
        assert s.card_ms is None  # no card on the CPU
    # siblings do not overlap: the checksum comes after the output is out
    for a, b in zip(kids, kids[1:]):
        assert a.t1_ns <= b.t0_ns
    names = [s.name for s in kids]
    assert names.index("td.checksum.adler") > names.index("td.decode.expand")


def _huffman_blocks(raw: bytes) -> int:
    """Huffman blocks of a raw DEFLATE stream as the plain inflater reads
    them: each ends in its one end-of-block symbol."""
    read, seen = RI._read_symbol, []

    def spy(*args):
        sym = read(*args)
        seen.append(sym == 256)
        return sym

    RI._read_symbol = spy
    try:
        RI.inflate_raw(raw)
    finally:
        RI._read_symbol = read
    return sum(seen)


def test_the_walk_counts_its_blocks():
    data = gzip.decompress(CORPUS.read_bytes())[: 256 * 1024]
    z = zlib.compress(data, 6)
    (out, total, _), spans = _traced(inflate_foreign_device, z, 16, device="cpu")
    assert out[:total].tobytes() == data
    walk, expand = [s for s in spans if s.name in STAGES]
    assert walk.name == "td.decode.tokenize" and expand.name == "td.decode.expand"
    blocks = _huffman_blocks(z[2:])
    assert blocks >= 2
    assert {k: walk.counts[k] for k in ("huffman_blocks", "stored_blocks", "fallback")} == {
        "huffman_blocks": blocks, "stored_blocks": 0, "fallback": 0}
    assert walk.counts["d2h_ns"] > 0
    # a read of the block's scalars each; the header's upload does not wait
    assert walk.counts["d2h_n"] == blocks and "h2d_n" not in walk.counts
    assert expand.counts["segments"] == 1


def test_a_walk_that_falls_back_says_so():
    skew = bytes(4000) + DATA[:3000]
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 8, zlib.Z_HUFFMAN_ONLY)
    raw = co.compress(skew) + co.flush()
    got, spans = _traced(inflate_foreign_device, raw, device="cpu")
    assert got[0][: got[1]].tobytes() == skew
    assert [s.name for s in spans] == ["td.api.h2d", "td.decode.tokenize",
                                       "td.decode.expand", "td.api.d2h"]
    walk = spans[1]
    # a 1-bit literal code: the lane tokenizer walks the block again, a
    # second read of its scalars
    assert {k: walk.counts[k] for k in ("huffman_blocks", "lane_blocks", "fallback",
                                        "d2h_n")} == {
        "huffman_blocks": 1, "lane_blocks": 1, "fallback": 0, "d2h_n": 2}


def test_no_profiler_no_spans():
    profiling.clear()
    assert _decompress() == DATA and _decompress_indexed() == DATA
    assert profiling.spans() == []
    # off, a tally is the shared no-op of a span, and a count does nothing
    assert profiling.tally("d2h") is profiling.span("td.x", device="cuda")
    with profiling.span("td.x"):
        profiling.count("huffman_blocks")
        with profiling.tally("d2h"):
            pass
    assert profiling.spans() == []
