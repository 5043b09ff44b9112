"""The program's spans of a traced decode window, for the decode metrics.

A decode call's root is ``td.api.decompress`` or ``td.api.decompress_
indexed``; its children are the copies and waits (``td.api.h2d``,
``td.api.d2h``), the checksum (``td.checksum.adler``) and the two decode
stages, ``td.decode.tokenize`` (the block walk, header parses included,
or the lanes' header parse and tokenizers) and ``td.decode.expand``, each
with the stream's stretch between two CUDA events.  Waits too many for a
span each (the walk's per-block reads, the expansion's per-segment ones)
are tallied on the stage's span: their host time as
``counts["d2h_ns"]`` and ``counts["h2d_ns"]``, their number as
``counts["d2h_n"]`` and ``counts["h2d_n"]``; the walk counts its Huffman
blocks, those its lane tokenizer walked (a 1-bit literal code), stored
blocks and whether it fell back to the general pipeline
(``counts["huffman_blocks"]``, ``["lane_blocks"]``, ``["stored_blocks"]``,
``["fallback"]``).

Each reading finds the cell's calls by the benchmark's call span,
``api.decompress`` or ``api.decompress_indexed``, pairs them with the
program's roots as ``spans.py`` does, and returns None where it finds
nothing to read: a program without these spans or counts, or a reading
that needs a card on the CPU.
"""

from __future__ import annotations

from portbench import spans
from portbench.trace import union

CALLS = ("api.decompress", "api.decompress_indexed")
STAGES = ("td.decode.tokenize", "td.decode.expand")
WAITS = ("h2d_ns", "d2h_ns")
SYNCS = ("h2d_n", "d2h_n")


def call_span(trace) -> str | None:
    """The cell's decode call span: the first of ``CALLS`` in the trace."""
    return next((name for name in CALLS if trace.of(name)), None)


def calls(trace) -> list:
    """The traced calls of the cell's decode call span."""
    name = call_span(trace)
    return trace.of(name) if name else []


def per_call(trace, reading):
    """The mean over the traced decode calls of ``reading(call, root,
    kids)``, as ``spans.per_call``."""
    name = call_span(trace)
    return None if name is None else spans.per_call(trace, name, reading)


def counted(keys: tuple, names: tuple):
    """A reading: the sum of ``counts[key]`` for each of ``keys`` over the
    call's spans named in ``names``; None where none holds any of them."""
    def reading(call, root, kids):
        found = [s.counts[k] for s in kids if s.name in names
                 for k in keys if k in getattr(s, "counts", {})]
        return sum(found) if found else None
    return reading


def copy_ms(call, root, kids) -> float:
    """Host ms in the copy spans and in the waits tallied on any span."""
    waited = sum(getattr(s, "counts", {}).get(k, 0) for s in [root, *kids] for k in WAITS)
    return spans.host_ms(kids, spans.COPIES) + waited / 1e6


def idle_ms(call, root, kids):
    """Time inside the decode stage spans, on the trace's clock, in which
    no device operation of the call runs; None for a call with none."""
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
