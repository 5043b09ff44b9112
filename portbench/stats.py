"""End-to-end metrics of a window, on the host clock.

Each takes all the calls and all the time of the window: a rate is the
bytes of every completed call over the time from the window's start to the
last completion, so a stall anywhere in the window lowers it; a tail is
the tail of every call, a failed one counting as infinitely late.  A
metric that does not apply to the window's kind of call returns None.
"""

from __future__ import annotations

import math

from portbench.loop import Window, latencies_ms


def _span_s(w: Window) -> float:
    ends = [end for _, end, *_ in w.calls if end is not None]
    return max(ends) - w.start


def _gbps(w: Window) -> float:
    return sum(c[3] for c in w.calls if c[1] is not None) / _span_s(w) / 1e9


def encode_gbps(w: Window, setup_s: float):
    return _gbps(w) if w.kind == "encode" else None


def compressed_ratio(w: Window, setup_s: float):
    if w.kind != "encode":
        return None
    done = [c for c in w.calls if c[1] is not None]
    return sum(c[4] for c in done) / sum(c[3] for c in done)


def percentile(values: list, q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default); infinite where it reaches a failed call."""
    v = sorted(values)
    x = (len(v) - 1) * q / 100
    lo, hi = math.floor(x), math.ceil(x)
    if math.isinf(v[hi]):
        return math.inf
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def call_p95_ms(w: Window, setup_s: float):
    p = percentile(latencies_ms(w), 95)
    return p if math.isfinite(p) else None


def setup_s(w: Window, setup_s: float):
    return setup_s


END_TO_END = {f.__name__: f for f in (encode_gbps, compressed_ratio, call_p95_ms, setup_s)}
