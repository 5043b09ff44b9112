"""One ``torch.profiler`` window over steady calls, reduced to what the
per-layer metrics read.

The benchmark annotates each call with its own span (the call module's
``SPAN``, such as ``api.compress``); on the profiler's timeline, which
places host and device events on one clock, every device operation that
starts inside a call's span belongs to that call.  Host-to-device and device-to-host copies
are the API layer's; kernels, memsets and device-to-device copies are the
codec's.  The device is busy where any device operation runs (the union of
their intervals), and idle elsewhere in the window, which runs from the
first call's start to the last call's end.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import statistics
import tempfile

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
SPAN_CAT = "user_annotation"


def export_events(prof) -> list:
    """The profiler's events, through its Chrome trace (a temporary file
    under TMPDIR, deleted once read)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def hand_kernels(csrc) -> set:
    """The names of the ``__global__`` functions in the program's CUDA
    sources: its hand-written kernels."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    names = set()
    for path in sorted(csrc.glob("*.cu")):
        names.update(pat.findall(path.read_text()))
    return names


def base_name(kernel: str) -> str:
    """A kernel's function name from the demangled name the trace shows:
    ``void (anonymous namespace)::k<false>(int*)`` -> ``k``."""
    s = kernel.replace("(anonymous namespace)::", "")
    s = re.split(r"[<(]", s, maxsplit=1)[0].strip()
    return s.split()[-1].split("::")[-1] if s else kernel


def is_host_copy(op: dict) -> bool:
    return op["cat"] == "gpu_memcpy" and ("HtoD" in op["name"] or "DtoH" in op["name"])


@dataclasses.dataclass
class Call:
    """One traced call: its span (microseconds on the trace's clock), the
    device operations that started in it, and its kernels' names."""

    span: str
    start: float
    end: float
    ops: list
    busy: float
    payload: int = -1
    shape: dict = dataclasses.field(default_factory=dict)

    @property
    def wall_ms(self) -> float:
        return (self.end - self.start) / 1e3

    @property
    def busy_ms(self) -> float:
        return self.busy / 1e3

    @property
    def codec_ops(self) -> list:
        return [op for op in self.ops if not is_host_copy(op)]

    @property
    def device_ms(self) -> float:
        return sum(op["dur"] for op in self.codec_ops) / 1e3

    def kernel_us(self, names: set) -> dict:
        """Device microseconds of each hand kernel the call launched."""
        out = {}
        for op in self.ops:
            if op["cat"] == "kernel":
                k = base_name(op["name"])
                if k in names:
                    out[k] = out.get(k, 0.0) + op["dur"]
        return out


@dataclasses.dataclass
class Trace:
    calls: list
    window_s: float
    busy_s: float
    hand: set
    peak: dict | None
    breakdown: dict

    def of(self, span: str) -> list:
        return [c for c in self.calls if c.span == span]


def union(intervals: list, lo: float, hi: float) -> list:
    """Merged (start, end) intervals, clipped to [lo, hi]."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _top_level(ops: list) -> list:
    """Host operations not nested in another, by start."""
    top = []
    for op in sorted(ops, key=lambda o: (o["ts"], -o["dur"])):
        if not top or op["ts"] >= top[-1]["ts"] + top[-1]["dur"]:
            top.append(op)
    return top


def _at(intervals: list, keys: list, t: float):
    """The (start, end, item) of sorted disjoint intervals that holds t;
    ``keys`` are their starts."""
    i = bisect.bisect_right(keys, t) - 1
    if i >= 0 and intervals[i][0] <= t < intervals[i][1]:
        return intervals[i]
    return None


def reduce(events: list, spans: set, payloads: list, hand: set,
           peak: dict | None, top: int = 10) -> Trace:
    """The calls, busy time and breakdown of a traced window.  ``payloads``
    gives the payload of each call in order."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    marks = sorted((e for e in xs if e.get("cat") == SPAN_CAT and e["name"] in spans),
                   key=lambda e: e["ts"])
    if not marks:
        raise RuntimeError("the trace holds no call span")
    lo, hi = marks[0]["ts"], max(m["ts"] + m["dur"] for m in marks)
    busy = union([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi)
    busy_us = sum(e - s for s, e in busy)

    starts = sorted(dev, key=lambda e: e["ts"])
    keys = [e["ts"] for e in starts]
    calls = []
    for n, m in enumerate(marks):
        s, e = m["ts"], m["ts"] + m["dur"]
        ops = starts[bisect.bisect_left(keys, s):bisect.bisect_left(keys, e)]
        inside = sum(b - a for a, b in union([(o["ts"], o["ts"] + o["dur"]) for o in ops], s, e))
        calls.append(Call(m["name"], s, e, ops, inside,
                          payloads[n] if n < len(payloads) else -1))

    # idle gaps, cut where a call starts or ends, each piece named by its
    # call span and the outermost host operation open in its middle;
    # outside every call, "between_calls"
    tid = marks[0].get("tid")
    host = [(o["ts"], o["ts"] + o["dur"], o["name"]) for o in _top_level(
        [e for e in xs if e.get("cat") == "cpu_op" and e.get("tid") == tid])]
    span_iv = [(m["ts"], m["ts"] + m["dur"], m["name"]) for m in marks]
    host_keys, span_keys = [h[0] for h in host], [m["ts"] for m in marks]
    cuts = sorted(t for iv in span_iv for t in iv[:2])
    gaps = {}
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        inner = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
        for x, y in zip([a] + inner, inner + [b]):
            if y <= x:
                continue
            mid = (x + y) / 2
            sp = _at(span_iv, span_keys, mid)
            if sp is None:
                name = "between_calls"
            else:
                op = _at(host, host_keys, mid)
                name = f"{sp[2]}:{op[2] if op else 'python'}"
            gaps[name] = gaps.get(name, 0.0) + (y - x) / 1e6
    by_op = {}
    for e in dev:
        if lo <= e["ts"] < hi:
            by_op[e["name"][:96]] = by_op.get(e["name"][:96], 0.0) + e["dur"] / 1e6
    breakdown = {
        "device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:top],
    }
    return Trace(calls, (hi - lo) / 1e6, busy_us / 1e6, hand, peak, breakdown)


def mean(values: list):
    return statistics.fmean(values) if values else None
