"""The port's spans (``tpu_deflate_torch.utils.profiling.span``) on the
CPU: off without a profiler, one root a public call under one, children
inside their root, shown in the Chrome trace, and streams unchanged."""

import ast
import json
import pathlib
import re
import zlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpu_deflate_torch as td
from tpu_deflate_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = (b"spans on the profiler's clock, " * 40 + bytes(range(256)) * 8) * 5
CFG = td.DeflateConfig(chunk_size=4096)
FW = td.DeflateConfig(**{**td.FULL_WINDOW.__dict__, "chunk_size": 4096})
ROOTS = {"compress_indexed": "td.api.compress_indexed", "compress": "td.api.compress",
         "compress_gzip": "td.api.compress_gzip"}
STAGES = ["td.encode.match", "td.encode.emit", "td.encode.pack"]


def _names_in_source() -> set:
    """Every span name the package can record."""
    pat = re.compile(r"""\bspan\(\s*["'](td\.[\w.]+)["']""")
    return {n for p in (REPO / "tpu_deflate_torch").rglob("*.py") for n in pat.findall(p.read_text())}


def _traced(fn, *args, **kwargs):
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args, **kwargs)
    return out, profiling.spans(), prof


def test_no_profiler_no_spans():
    profiling.clear()
    stream, index = td.compress_indexed(DATA, CFG, device="cpu")
    assert zlib.decompress(stream) == DATA and len(index) == -(-len(DATA) // 4096)
    assert profiling.spans() == []
    # off, a span is one shared no-op: no CUDA event is made, even for "cuda"
    assert profiling.span("td.x", device="cuda") is profiling.span("td.y")
    with profiling.span("td.x", device="cuda"):
        pass
    assert profiling.spans() == []


@pytest.mark.parametrize("call", sorted(ROOTS))
@pytest.mark.parametrize("config", [CFG, FW], ids=["w256", "full_window"])
def test_one_root_a_call_and_children_inside_it(call, config):
    out, spans, _ = _traced(lambda: [getattr(td, call)(DATA, config, device="cpu")
                                     for _ in range(2)])
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == [ROOTS[call]] * 2
    by_id = {s.id: s for s in spans}
    for root in roots:
        kids = sorted((s for s in spans if s.root == root.id and s is not root),
                      key=lambda s: s.t0_ns)
        assert [s.name for s in kids if s.name in STAGES] == STAGES
        assert {"td.api.h2d", "td.checksum.adler", "td.api.d2h"} <= {s.name for s in kids}
        for s in kids:
            assert s.parent in by_id and by_id[s.parent].root == root.id
            assert root.t0_ns <= s.t0_ns <= s.t1_ns <= root.t1_ns
            assert s.card_ms is None  # no card on the CPU
        # siblings do not overlap: the sum of the children is inside the root
        assert sum(s.t1_ns - s.t0_ns for s in kids if s.parent == root.id) <= (
            root.t1_ns - root.t0_ns)
    assert {s.name for s in spans} <= _names_in_source()


def test_the_stage_spans_run_where_lanes_encode_without_a_root():
    _, spans, _ = _traced(td.compress_gzip_members, DATA, CFG, device="cpu")
    assert [s.name for s in sorted(spans, key=lambda s: s.t0_ns)] == STAGES
    assert all(s.parent is None and s.root == s.id for s in spans)


def test_the_chrome_trace_holds_each_span(tmp_path):
    _, spans, prof = _traced(td.compress_indexed, DATA, CFG, device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    marks = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(marks) == sorted(s.name for s in spans)


@pytest.mark.parametrize("config", [CFG, FW], ids=["w256", "full_window"])
def test_streams_are_the_same_traced_or_not(config):
    plain = td.compress_indexed(DATA, config, device="cpu")
    traced, spans, _ = _traced(td.compress_indexed, DATA, config, device="cpu")
    assert spans and traced[0] == plain[0] and list(traced[1]) == list(plain[1])
    assert td.compress_gzip(DATA, config, device="cpu") == _traced(
        td.compress_gzip, DATA, config, device="cpu")[0]


def test_a_span_ends_when_its_body_raises():
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with profiling.span("td.outer"):
                with profiling.span("td.inner"):
                    raise ValueError("inside")
        with profiling.span("td.after"):
            torch.zeros(1)
    inner, outer, after = profiling.spans()
    assert (inner.name, outer.name, after.name) == ("td.inner", "td.outer", "td.after")
    assert inner.parent == outer.id == inner.root and outer.parent is None
    assert after.parent is None and after.root == after.id  # the stack was unwound


def test_no_span_name_is_a_benchmark_call_span():
    """``portbench/trace.reduce`` takes an annotation named like a call
    module's ``SPAN`` as a call: the program's names must differ."""
    calls = set()
    for path in (REPO / "portbench" / "calls").glob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and [t.id for t in node.targets] == ["SPAN"]:
                calls.add(node.value.value)
    names = _names_in_source()
    assert calls and set(ROOTS.values()) | set(STAGES) <= names
    assert all(n.startswith("td.") for n in names) and not names & calls
