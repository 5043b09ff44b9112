"""The program's own spans (``tpu_deflate_torch.utils.profiling``) of a
traced window, set on the trace's clock.

The program records a span at each layer boundary of its compress path
while the profiler records: a root for each public call (``td.api.*``)
and children for the host<->device copies (``td.api.h2d``,
``td.api.d2h``), the checksum (``td.checksum.adler``) and the encode's
stages (``td.encode.match``, ``.emit``, ``.pack``, each with the stream's
stretch between two CUDA events, ``card_ms``).  The window's roots are
the last as many roots as the trace has calls; root k belongs to call k,
and a span's host time t maps onto the trace's clock (microseconds) as
``call.start + (t - root.t0_ns) / 1e3``.

Each reader returns None where the program records no spans (a program
without the recorder), where the roots and the calls differ in number,
or where what it reads is absent (``card_ms`` on the CPU; idle with no
device operation in the trace).
"""

from __future__ import annotations

import importlib

from portbench.trace import mean, union

STAGES = ("td.encode.match", "td.encode.emit", "td.encode.pack")
COPIES = ("td.api.h2d", "td.api.d2h")
CHECKSUM = ("td.checksum.adler",)


def program_spans():
    """The program's recorded spans, or None where it has no recorder."""
    try:
        profiling = importlib.import_module("tpu_deflate_torch.utils.profiling")
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def pair(calls: list, recorded) -> list | None:
    """[(call, root, the root's other spans)] for the traced calls, or
    None where the last roots recorded do not match them one to one."""
    if not calls or not recorded:
        return None
    roots = sorted((s for s in recorded if s.parent is None), key=lambda s: s.t0_ns)
    if len(roots) < len(calls):
        return None
    roots = roots[-len(calls):]
    if any(r.host_ms > c.wall_ms for c, r in zip(calls, roots)):
        return None  # a root longer than its call is not that call's
    kids = {r.id: [] for r in roots}
    for s in recorded:
        if s.root in kids and s.parent is not None:
            kids[s.root].append(s)
    return [(c, r, kids[r.id]) for c, r in zip(calls, roots)]


def per_call(trace, span: str, reading):
    """The mean over the traced calls of ``reading(call, root, kids)``;
    None where the spans do not pair with the calls or any reading is
    None."""
    paired = pair(trace.of(span), program_spans())
    if paired is None:
        return None
    values = [reading(c, r, k) for c, r, k in paired]
    return None if any(v is None for v in values) else mean(values)


def host_ms(kids: list, names) -> float:
    return sum(s.host_ms for s in kids if s.name in names)


def self_ms(call, root, kids) -> float:
    """The root's host time less its children's."""
    return root.host_ms - sum(s.host_ms for s in kids if s.parent == root.id)


def card_ms(name: str):
    def reading(call, root, kids):
        stretches = [s.card_ms for s in kids if s.name == name]
        if not stretches or any(v is None for v in stretches):
            return None
        return sum(stretches)
    return reading


def idle_ms(call, root, kids):
    """Time inside the stage spans, on the trace's clock, in which no
    device operation of the call runs; None for a call with none."""
    if not call.ops:
        return None
    busy = [(op["ts"], op["ts"] + op["dur"]) for op in call.ops]
    idle = 0.0
    for s in kids:
        if s.name in STAGES:
            lo = call.start + (s.t0_ns - root.t0_ns) / 1e3
            hi = call.start + (s.t1_ns - root.t0_ns) / 1e3
            idle += (hi - lo) - sum(b - a for a, b in union(busy, lo, hi))
    return idle / 1e3
