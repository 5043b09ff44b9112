"""The decode cells (``zlib6.foreign``, and ``fw-dynamic.read``: the read
mix at ``fw-dynamic``, kept out of ``BENCHMARK.json`` for its noise) on
the CPU, through the port's plain paths at a small size: a short run of
each is correct and a traced one reads the decode metrics; each planted
fault, wrapped around the program's own call, fails the judge; streams of
another zlib level fail the ratio alone.  And the decode readers and
roofline counts on made-up spans and shapes."""

import time
import zlib

import pytest

from portbench import blocks, decode_spans, manifest, rooflines
from portbench.program import Port
from portbench.run import run_cell
from portbench.trace import Call, Trace, hand_kernels
from tpu_deflate_torch.utils.profiling import Span

SMALL = {"payload_bytes": 2 * 65536 + 777, "sample": 4, "trace_calls": 2}
CELLS = ["zlib6.foreign", "fw-dynamic.read"]
HOST = ["api.self_ms.decode", "api.copy_ms.decode", "checksum.ms.decode"]
TRACE = ["decode.device_ms", "decode.ops_per_call", "device.idle_pct.decode"]


def with_read(m: dict) -> dict:
    """The manifest with ``fw-dynamic.read`` among its cells, reporting
    the decode metrics that are not the walk's."""
    m["workloads"].append({"name": "fw-dynamic.read", "config": "fw-dynamic",
                           "traffic": "read", "chips": 1, "why": "the indexed decode"})
    for metric in m["per_layer"]:
        if metric.get("workloads") == ["zlib6.foreign"] and not metric["name"].startswith(
                "foreign."):
            metric["workloads"].append("fw-dynamic.read")
    return m


def small_cell(workload: str, ratio: float = 1.0, **mix) -> dict:
    """The cell at a small size, its ratio limit set for that size."""
    cell = manifest.cell(workload, with_read(manifest.load_manifest()))
    cell["traffic"].update(SMALL, **mix)
    cell["config"]["limits"] = {"ratio": ratio}
    return cell


def run(cell, program, trace=False):
    return run_cell(cell, 2**31 + 17, 0.3, trace, program, time.time(), cuda=False)


def failing(r) -> list:
    return [k for k, (v, lim) in r["checks"].items() if v > lim]


class Wrapped:
    """The program, with the answers of its decode calls changed by
    ``change(answer, stream)``."""

    def __init__(self, port, change):
        self.port, self.change = port, change

    def config(self, fields):
        return self.port.config(fields)

    def __getattr__(self, name):
        return getattr(self.port, name)

    def decompress(self, stream, config):
        return self.change(self.port.decompress(stream, config), stream)

    def decompress_indexed(self, stream, index, config):
        return self.change(self.port.decompress_indexed(stream, index, config), stream)


def _altered(answer, stream):
    at = len(answer) // 3
    return answer[:at] + bytes([answer[at] ^ 0x20]) + answer[at + 1:]


class Raises:
    """Raises in every call after the set-up's round of the 5 payloads."""

    def __init__(self):
        self.calls = 0

    def __call__(self, answer, stream):
        self.calls += 1
        if self.calls > 5:
            raise RuntimeError("a planted fault")
        return answer


FAULTS = {
    "altered": lambda: _altered,
    "half": lambda: lambda answer, stream: answer[:len(answer) // 2],
    "stream_as_is": lambda: lambda answer, stream: stream,
    "raises": Raises,
}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(workload, trace):
    r = run(small_cell(workload), Port("cpu"), trace=trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r["checks"]
    assert r["checks"]["bytes_bad"] == (0, 0)
    got = {k: v["value"] for k, v in r["metrics"].items()}
    if trace:
        assert all(got.get(name, 0) > 0 for name in HOST), got
        assert set(TRACE) <= set(got)
        # no card: no CUDA event, no device operation, no peak
        assert not {"decode.tokenize.card_ms", "decode.idle_ms",
                    "kernels.roofline_pct.decode"} & set(got)
    else:
        assert set(got) == {"call_p95_ms", "setup_s"}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_fails_the_judge(workload, fault):
    r = run(small_cell(workload), Wrapped(Port("cpu"), FAULTS[fault]()))
    assert not r["correct"]
    assert failing(r) == (["calls_failed"] if fault == "raises" else ["bytes_bad"])


class Unchecked(Wrapped):
    """Stock zlib's raw inflate of the body in the program's place: right
    answers, but no trailer verified and no error on a stream cut short."""

    def __init__(self, port):
        super().__init__(port, None)

    def decompress(self, stream, config):
        return zlib.decompressobj(-15).decompress(stream[2:-4])


def test_a_decode_that_accepts_corrupt_streams_fails_the_judge():
    r = run(small_cell("zlib6.foreign"), Unchecked(Port("cpu")))
    assert failing(r) == ["corrupt_accepted"] and r["checks"]["corrupt_accepted"][0] == 2


class BadStreams(Wrapped):
    """The program, with the header check bits of its compressed streams
    flipped, which its indexed decode does not read: the read cell's
    traffic is then not what it states."""

    def __init__(self, port):
        super().__init__(port, lambda answer, stream: answer)

    def compress_indexed(self, data, config):
        stream, index = self.port.compress_indexed(data, config)
        return stream[:1] + bytes([stream[1] ^ 0x01]) + stream[2:], index


def test_streams_that_fail_their_checks_fail_the_read_cell():
    """Judged after the window, not at set-up."""
    r = run(small_cell("fw-dynamic.read"), BadStreams(Port("cpu")))
    assert failing(r) == ["frames_bad"] and r["checks"]["frames_bad"][0] == 5


def test_streams_of_level_5_fail_the_ratio_alone():
    """Held at the level 6 streams' ratio, which they meet, level 5's
    streams fail on the ratio alone."""
    sound = run(small_cell("zlib6.foreign"), Port("cpu"))["checks"]["ratio"][0]
    r = run(small_cell("zlib6.foreign", ratio=sound, level=5), Port("cpu"))
    assert r["checks"]["ratio"][0] > sound and failing(r) == ["ratio"]


def test_the_readers_on_made_up_spans(monkeypatch):
    """One call of 1 ms whose root lasts 0.9 ms: h2d 0.1, tokenize 0.4
    (with 0.05 ms of 3 tallied reads and 0.02 of 12 uploads, 3 Huffman
    blocks), expand 0.2 (one segment, 2 reads and an upload), d2h 0.1 ms;
    self 0.1 ms.  One device op of 0.3 ms inside the tokenize span."""
    ms = 1_000_000
    t0 = 5 * ms
    parts = [("td.api.h2d", 0.0, 0.1, None, {}),
             ("td.decode.tokenize", 0.1, 0.5, 0.45,
              {"d2h_ns": 50_000, "h2d_ns": 20_000, "d2h_n": 3, "h2d_n": 12,
               "huffman_blocks": 3, "fallback": 0}),
             ("td.decode.expand", 0.5, 0.7, 0.2, {"segments": 1, "d2h_n": 2, "h2d_n": 1}),
             ("td.api.d2h", 0.7, 0.8, None, {})]
    kids = [Span(name, 2 + i, 1, 1, t0 + int(a * ms), t0 + int(b * ms), card, counts)
            for i, (name, a, b, card, counts) in enumerate(parts)]
    root = Span("td.api.decompress", 1, None, 1, t0, t0 + int(0.9 * ms))
    op = {"name": "k", "cat": "kernel", "ts": 1150.0, "dur": 300.0}
    trace = Trace([Call("api.decompress", 1000.0, 2000.0, [op], 300.0)], 0.001, 0.0003,
                  set(), None, {})
    monkeypatch.setattr(decode_spans.spans, "program_spans", lambda: [root, *kids])
    read = {name: manifest.load_module("metrics", name).read(trace) for name in [
        "api.self_ms.decode", "api.copy_ms.decode", "decode.tokenize.card_ms",
        "decode.expand.card_ms", "decode.idle_ms", "foreign.syncs_per_call",
        "foreign.blocks_per_call", "foreign.fallbacks_per_call", "decode.ops_per_call",
        "device.idle_pct.decode"]}
    assert read == pytest.approx({
        "api.self_ms.decode": 0.1, "api.copy_ms.decode": 0.27, "decode.tokenize.card_ms": 0.45,
        "decode.expand.card_ms": 0.2, "decode.idle_ms": 0.3, "foreign.syncs_per_call": 18,
        "foreign.blocks_per_call": 3,
        "foreign.fallbacks_per_call": 0, "decode.ops_per_call": 1,
        "device.idle_pct.decode": 70.0}, abs=1e-9)
    # a program whose spans carry no counts (the decode spans' parent)
    for s in kids:
        del s.counts
    for name in ("foreign.syncs_per_call", "foreign.blocks_per_call"):
        assert manifest.load_module("metrics", name).read(trace) is None
    assert manifest.load_module("metrics", "api.copy_ms.decode").read(trace) == pytest.approx(0.2)
    monkeypatch.setattr(decode_spans.spans, "program_spans", lambda: [])
    assert manifest.load_module("metrics", "api.self_ms.decode").read(trace) is None


DECODE = ["k1d_kernel", "ent_kernel", "k3d_kernel", "visit_kernel", "mono_compact_kernel",
          "expand2_kernel", "resolve_tile_kernel", "resolve_chase_kernel",
          "tokenize_static_kernel", "tokenize_dyn_kernel", "expand3_kernel"]


def test_every_decode_kernel_has_a_count():
    assert set(DECODE) <= hand_kernels(Port("cpu").csrc())
    for k in DECODE:
        assert (manifest.HERE / "rooflines" / f"{k}.py").is_file()


def test_the_counts_of_a_stream():
    data = bytes(range(256)) * 64 + b"zlib's default level, " * 2000
    stream = zlib.compress(data, 6)
    w = blocks.walk(stream[2:-4])
    s = blocks.shape([w], len(data), len(stream))
    assert s["blocks"] == {"stored": 0, "static": 0, "dynamic": 1} and s["lanes"] == 1
    assert s["huffman_bits"] > s["header_bits"] > 17 and s["code_lengths"] >= 258
    tokens = s["literals"] + s["matches"]
    assert 256 <= s["literals"] and tokens < len(data)
    count = {k: rooflines.least_bytes(k, s) for k in DECODE}
    assert count["k3d_kernel"] == 12 * tokens
    assert count["expand2_kernel"] == count["expand3_kernel"] == 12 * tokens + len(data)
    assert count["k1d_kernel"] + count["visit_kernel"] in (len(stream) - 6, len(stream) - 5)
    assert count["tokenize_static_kernel"] == count["resolve_tile_kernel"] == 0
    # a stored block moves the expansion's count to resolve_roots
    stored = zlib.compress(data, 0)
    s0 = blocks.shape([blocks.walk(stored[2:-4])], len(data), len(stored))
    assert s0["stored_bytes"] == len(data) and s0["literals"] == s0["matches"] == 0
    assert rooflines.least_bytes("expand2_kernel", s0) == 0
    assert rooflines.least_bytes("resolve_tile_kernel", s0) == (
        12 * s0["blocks"]["stored"] + 2 * len(data))
