"""``spans.py`` and the metrics that read the program's spans: known values
on a made-up trace, None where roots and calls do not pair, and a traced
run on the CPU."""

import time

import pytest

from portbench import manifest, spans
from portbench.program import Port
from portbench.run import run_cell
from portbench.trace import Call, Trace
from tpu_deflate_torch.utils.profiling import Span

HOST = ["api.self_ms.encode", "api.copy_ms.encode", "checksum.host_ms.encode", "encode.host_ms"]
CARD = ["encode.match.card_ms", "encode.emit.card_ms", "encode.pack.card_ms"]
NEW = HOST + ["encode.idle_ms"] + CARD


def read(name, trace):
    return manifest.load_module("metrics", name).read(trace)


def a_call(root_id: int, t0_ns: int, start_us: float, ops: list):
    """A call of 1 ms on the trace whose root lasts 0.9 ms from t0_ns:
    h2d 0.1, match 0.2, emit 0.1, pack 0.1, checksum 0.05, d2h 0.2 ms;
    self 0.15 ms.  The stages map onto [start + 200, start + 600] us."""
    ms = 1_000_000
    parts = [("td.api.h2d", 0.05, 0.15, None), ("td.encode.match", 0.2, 0.4, 0.3),
             ("td.encode.emit", 0.4, 0.5, 0.2), ("td.encode.pack", 0.5, 0.6, 0.1),
             ("td.checksum.adler", 0.6, 0.65, None), ("td.api.d2h", 0.65, 0.85, None)]
    kids = [Span(name, root_id + 1 + i, root_id, root_id, t0_ns + int(a * ms),
                 t0_ns + int(b * ms), card)
            for i, (name, a, b, card) in enumerate(parts)]
    root = Span("td.api.compress_indexed", root_id, None, root_id, t0_ns, t0_ns + int(0.9 * ms))
    call = Call("api.compress", start_us, start_us + 1000.0, ops, 0.0)
    return call, kids + [root]


def op(ts, dur):
    return {"name": "k", "cat": "kernel", "ts": ts, "dur": dur}


@pytest.fixture
def made_up(monkeypatch):
    """Two calls, and a stale root from before the window.  Call 1: device
    ops over [1250, 1350] and [1450, 1550] us, so the stages idle 100 +
    50 + 50 us; call 2: one op after its stages, which idle 400 us."""
    stale = Span("td.api.compress_indexed", 1, None, 1, 0, 10)
    c1, s1 = a_call(10, 5_000_000, 1000.0, [op(1250, 100), op(1450, 100)])
    c2, s2 = a_call(20, 8_000_000, 3000.0, [op(3700, 50)])
    recorded = [stale] + s1 + s2
    monkeypatch.setattr(spans, "program_spans", lambda: recorded)
    return Trace([c1, c2], 0.003, 0.00025, set(), None, {}), recorded


def test_known_values_on_a_made_up_trace(made_up):
    trace, _ = made_up
    want = {"api.self_ms.encode": 0.15, "api.copy_ms.encode": 0.3,
            "checksum.host_ms.encode": 0.05, "encode.host_ms": 0.4, "encode.idle_ms": 0.3,
            "encode.match.card_ms": 0.3, "encode.emit.card_ms": 0.2, "encode.pack.card_ms": 0.1}
    got = {name: read(name, trace) for name in NEW}
    assert got == pytest.approx(want, abs=1e-9)
    # the host readings add up to the roots' 0.9 ms
    assert sum(got[n] for n in HOST) == pytest.approx(0.9)


def test_none_where_roots_and_calls_do_not_pair(made_up, monkeypatch):
    trace, recorded = made_up
    one_root = [s for s in recorded if s.root == 20]
    monkeypatch.setattr(spans, "program_spans", lambda: one_root)
    assert all(read(name, trace) is None for name in NEW)
    monkeypatch.setattr(spans, "program_spans", lambda: None)  # a program without spans
    assert all(read(name, trace) is None for name in NEW)
    long_root = [s for s in recorded if s.parent is not None or s.id == 20] + [
        Span("td.api.compress_indexed", 10, None, 10, 5_000_000, 7_000_000)]
    monkeypatch.setattr(spans, "program_spans", lambda: long_root)
    assert read("api.self_ms.encode", trace) is None  # 2 ms does not fit a 1 ms call


def test_idle_and_card_are_none_without_a_card(made_up):
    trace, recorded = made_up
    for s in recorded:
        s.card_ms = None
    for c in trace.calls:
        c.ops = []
    assert [read(name, trace) for name in ["encode.idle_ms"] + CARD] == [None] * 4
    assert all(read(name, trace) is not None for name in HOST)


def test_a_traced_run_on_the_cpu_reads_every_host_metric():
    cell = manifest.cell("w256-static.bulk")
    cell["traffic"].update({"payload_bytes": 2 * 65536 + 777, "sample": 4, "trace_calls": 2})
    cell["config"]["limits"] = {"ratio": 1.0}
    r = run_cell(cell, 2**31 + 11, 0.3, True, Port("cpu"), time.time(), cuda=False)
    assert r["correct"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert all(got.get(name, 0) > 0 for name in HOST), got
    assert not set(got) & ({"encode.idle_ms"} | set(CARD))
