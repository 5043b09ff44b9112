"""Throughput counters for stages, and a device trace.

    prof = Profiler(device="cuda")
    with prof.stage("encode", nbytes=len(data)):
        compress(data, device="cuda")
    print(prof.report())   # [{"name", "bytes", "seconds", "calls", "GB/s"}]

On a CUDA device a stage is timed by CUDA events recorded on the current
stream around it, and the stage waits for its stop event, so the time is
the device's; on the CPU by the host clock.  ``device_trace`` writes a
``torch.profiler`` trace (Chrome trace JSON, one file a trace) of what runs
inside it.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

import torch


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
    """Stage profiler on ``device`` (CUDA events there; the host clock on
    the CPU)."""

    counters: dict = field(default_factory=dict)
    device: str = "cuda"

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        c = self.counters.setdefault(name, Counter(name))
        dev = torch.device(self.device)
        if dev.type == "cuda":
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(torch.cuda.current_stream(dev))
        else:
            t0 = time.perf_counter()
        try:
            yield c
        finally:
            if dev.type == "cuda":
                stop.record(torch.cuda.current_stream(dev))
                stop.synchronize()
                c.seconds += start.elapsed_time(stop) / 1e3
            else:
                c.seconds += time.perf_counter() - t0
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
