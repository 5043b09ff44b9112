"""End-to-end arithmetic on made-up windows, and the trace's reduction on
made-up profiler events."""

import math

import numpy as np
import pytest

from portbench import stats
from portbench.loop import Window
from portbench.trace import base_name, reduce, union


def window(latencies_s, gap_s=0.0, stall_at=None, stall_s=0.0, raw=8 << 20, packed=5 << 20):
    calls, t = [], 100.0
    for i, d in enumerate(latencies_s):
        if i == stall_at:
            t += stall_s
        calls.append((t, t + d, i % 5, raw, packed))
        t += d + gap_s
    return Window("encode", 100.0, calls, [], {})


def test_rate_over_the_whole_window():
    w = window([0.02] * 100)
    assert stats.encode_gbps(w, 0) == pytest.approx(100 * (8 << 20) / 2.0 / 1e9)
    assert stats.compressed_ratio(w, 0) == pytest.approx(5 / 8)
    w.kind = "decode"
    assert stats.encode_gbps(w, 0) is None and stats.compressed_ratio(w, 0) is None


def test_a_stall_inside_the_window_lowers_the_rate():
    steady = stats.encode_gbps(window([0.02] * 100), 0)
    stalled = stats.encode_gbps(window([0.02] * 100, stall_at=50, stall_s=0.5), 0)
    assert stalled == pytest.approx(steady * 2.0 / 2.5)


def test_p95_is_numpy_linear_and_counts_every_call():
    rng = np.random.default_rng(7)
    lat = list(rng.uniform(0.01, 0.03, 257))
    w = window(lat)
    assert stats.call_p95_ms(w, 0) == pytest.approx(np.percentile(np.array(lat) * 1e3, 95))


def test_a_failed_call_is_infinitely_late():
    w = window([0.02] * 10)
    w.calls[3] = (w.calls[3][0], None, 3, 0, 0)
    assert w.failed == 1
    assert stats.percentile([1.0, 2.0, math.inf], 95) == math.inf
    assert stats.call_p95_ms(w, 0) is None
    assert stats.encode_gbps(w, 0) == pytest.approx(9 * (8 << 20) / (w.calls[-1][1] - 100.0) / 1e9)


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_union_clips_and_merges():
    assert union([(0, 10), (5, 20), (30, 40)], 2, 35) == [[2, 20], [30, 35]]


def test_trace_reduction():
    k = "void (anonymous namespace)::match2_kernel<true>(unsigned char const*, int)"
    events = [
        ev("user_annotation", "api.compress", 0, 100),
        ev("user_annotation", "api.compress", 120, 80),
        ev("cpu_op", "aten::copy_", 0, 30),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10, 10, tid=7),
        ev("kernel", k, 40, 20, tid=7),
        ev("gpu_memset", "Memset (Device)", 60, 5, tid=7),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 90, 10, tid=7),
        ev("kernel", "void at::native::fill<int>(int)", 150, 30, tid=7),
    ]
    t = reduce(events, {"api.compress"}, [0, 1], {"match2_kernel"}, None)
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx(75e-6)
    first, second = t.calls
    assert first.wall_ms == pytest.approx(0.1) and first.busy_ms == pytest.approx(0.045)
    assert first.device_ms == pytest.approx(0.025) and len(first.codec_ops) == 2
    assert first.kernel_us({"match2_kernel"}) == {"match2_kernel": 20}
    assert second.payload == 1 and second.device_ms == pytest.approx(0.03)
    gaps = dict(t.breakdown["idle_gaps"])
    assert gaps["between_calls"] == pytest.approx(20e-6)
    assert gaps["api.compress:aten::copy_"] == pytest.approx(10e-6)
    assert gaps["api.compress:python"] == pytest.approx(95e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)
    assert t.breakdown["device_ops"][0] == ["void at::native::fill<int>(int)", pytest.approx(30e-6)]


@pytest.mark.parametrize("name, base", [
    ("(anonymous namespace)::match2_kernel(unsigned char const*, int const*, int*, int*, int, int, int, int, int)",
     "match2_kernel"),
    ("void (anonymous namespace)::tokenize_static_kernel<false, unsigned short>(unsigned char const*)",
     "tokenize_static_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<bool> >(int)",
     "vectorized_elementwise_kernel"),
    ("Memcpy DtoD (Device -> Device)", "DtoD"),
])
def test_base_name(name, base):
    assert base_name(name) == base
