"""Spans on the profiler's clock, throughput counters for stages, and a
device trace.

Spans mark the layer boundaries of the compress and decompress paths
(``td.api.*``, ``td.encode.*``, ``td.decode.*``, ``td.checksum.*``).  They
record only while a ``torch.profiler`` is recording; otherwise ``span``
returns one shared no-op context, so an untraced call pays a flag test a
span:

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        compress_indexed(data, device="cuda")
    for s in spans():   # name, id, parent, root, t0_ns, t1_ns, card_ms, counts
        ...
    prof.export_chrome_trace("trace.json")   # the spans beside the kernels

A span enters ``torch.profiler.record_function`` under its name, so it
shows in the Chrome trace on the clock of the device operations; where it
is given a CUDA device it records a timing event on the current stream at
each end, and ``card_ms`` is the stretch of the stream between them:
launch gaps included, not the card's busy time.  Spans live in a bounded
buffer of this process, as the profiler's own state does.

``count(key, n)`` adds n to the innermost open span's ``counts[key]``, and
``tally(kind)`` adds the host nanoseconds of its body there to
``counts[kind + "_ns"]`` and one to ``counts[kind + "_n"]``: work done
inside a span, and waits too many for a span each (one a block of a
stream), are read off the span.  Without a profiler both are the flag
test alone.

    prof = Profiler(device="cuda")
    with prof.stage("encode", nbytes=len(data)):
        compress(data, device="cuda")
    print(prof.report())   # [{"name", "bytes", "seconds", "calls", "GB/s"}]

On a CUDA device a stage is timed by the same event pair, and the stage
waits for its stop event, so its seconds are stream time between the
markers, launch gaps included; on the CPU they are the host clock's.
``device_trace`` writes a ``torch.profiler`` trace (Chrome trace JSON,
one file a trace) of what runs inside it.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

_BUFFER = collections.deque(maxlen=4096)
_IDS = itertools.count(1)
_OPEN = contextvars.ContextVar("tpu_deflate_torch_open_span", default=None)


class _Off:
    """The no-op context of a span while no profiler records (half the
    cost of ``contextlib.nullcontext``, whose methods take more work)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        return None


_OFF = _Off()


class _Stretch:
    """A stretch of the host clock and, on a CUDA device, a timing event
    pair on the stream that is current when it starts."""

    __slots__ = ("t0_ns", "t1_ns", "_stream", "_start", "_stop")

    def __init__(self, device=None):
        self._stream = self._start = self._stop = None
        if device is not None and torch.device(device).type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self._stream)
        self.t0_ns = time.perf_counter_ns()
        self.t1_ns = None

    def stop(self) -> None:
        if self._stream is not None:
            self._stop = torch.cuda.Event(enable_timing=True)
            self._stop.record(self._stream)
        self.t1_ns = time.perf_counter_ns()

    def card_ms(self):
        """The stream's time between the events (waits for the stop
        event), or None without a card."""
        if self._stop is None:
            return None
        self._stop.synchronize()
        return self._start.elapsed_time(self._stop)


@dataclass
class Span:
    """One recorded span: host times from ``time.perf_counter_ns``;
    ``card_ms`` the stream's stretch between its events, None without a
    card.  ``root`` is the id of the outermost span around it (its own
    where it has no parent).  ``counts`` holds what ``count`` and
    ``tally`` added while it was the innermost open span."""

    name: str
    id: int
    parent: int | None
    root: int
    t0_ns: int
    t1_ns: int
    card_ms: float | None = None
    counts: dict = field(default_factory=dict)
    _stretch: _Stretch | None = field(default=None, repr=False, compare=False)

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


class _Recording:
    """An open span: its place among the open spans, its annotation in
    the profiler and its stretch."""

    __slots__ = ("name", "device", "id", "parent", "root", "token", "fn", "stretch",
                 "counts")

    def __init__(self, name: str, device):
        self.name, self.device = name, device
        self.counts = {}

    def __enter__(self):
        self.id = next(_IDS)
        parent = _OPEN.get()
        self.parent, self.root = (None, self.id) if parent is None else (parent.id, parent.root)
        self.token = _OPEN.set(self)
        self.fn = _autograd_profiler.record_function(self.name)
        self.fn.__enter__()
        self.stretch = _Stretch(self.device)

    def __exit__(self, *exc):
        self.stretch.stop()
        self.fn.__exit__(*exc)
        _OPEN.reset(self.token)
        s = self.stretch
        _BUFFER.append(Span(self.name, self.id, self.parent, self.root, s.t0_ns, s.t1_ns,
                            counts=self.counts, _stretch=s))
        return False


def span(name: str, device=None):
    """A context that records a span named ``name`` (``td.<layer>.<stage>``)
    while a ``torch.profiler`` is recording, with card events where
    ``device`` is a CUDA device; a shared no-op context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, device)


def count(key: str, n=1) -> None:
    """Add n to ``counts[key]`` of the innermost open span while a
    ``torch.profiler`` is recording; nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    inner = _OPEN.get()
    if inner is not None:
        inner.counts[key] = inner.counts.get(key, 0) + n


class _Tally:
    """Adds the host nanoseconds of its body, and one, to two counts."""

    __slots__ = ("kind", "t0_ns")

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        self.t0_ns = time.perf_counter_ns()

    def __exit__(self, *exc):
        count(self.kind + "_ns", time.perf_counter_ns() - self.t0_ns)
        count(self.kind + "_n")
        return False


def tally(kind: str):
    """A context that adds the host nanoseconds of its body to
    ``counts[kind + "_ns"]``, and one to ``counts[kind + "_n"]``, of the
    innermost open span while a ``torch.profiler`` is recording (``"d2h"``:
    a wait for the card's scalars; ``"h2d"``: an upload from pageable
    memory, which waits for the stream); the shared no-op context
    otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Tally(kind)


def spans() -> list:
    """The spans recorded so far, in the order they ended, each with its
    ``card_ms`` read (this waits for their events)."""
    out = list(_BUFFER)
    for s in out:
        if s._stretch is not None:
            s.card_ms, s._stretch = s._stretch.card_ms(), None
    return out


def clear() -> None:
    """Empty the buffer of spans."""
    _BUFFER.clear()


@dataclass
class Counter:
    """Throughput counter for one stage."""

    name: str
    bytes_processed: int = 0
    seconds: float = 0.0
    calls: int = 0

    @property
    def gbps(self) -> float:
        return self.bytes_processed / self.seconds / 1e9 if self.seconds else 0.0

    def as_dict(self):
        return {
            "name": self.name,
            "bytes": self.bytes_processed,
            "seconds": round(self.seconds, 6),
            "calls": self.calls,
            "GB/s": round(self.gbps, 4),
        }


@dataclass
class Profiler:
    """Stage profiler on ``device``: stream time between CUDA events there,
    launch gaps included; the host clock on the CPU."""

    counters: dict = field(default_factory=dict)
    device: str = "cuda"

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        c = self.counters.setdefault(name, Counter(name))
        s = _Stretch(self.device)
        try:
            yield c
        finally:
            s.stop()
            card = s.card_ms()
            c.seconds += (s.t1_ns - s.t0_ns) / 1e9 if card is None else card / 1e3
            c.bytes_processed += nbytes
            c.calls += 1

    def report(self) -> str:
        return json.dumps([c.as_dict() for c in self.counters.values()])


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """A ``torch.profiler`` trace of the host and, on a CUDA device, the
    card, written into logdir as Chrome trace JSON when the block ends."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
