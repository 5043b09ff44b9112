"""The general traffic generator: one caller, calls back to back.

A mix is a data file (``traffic/<name>.json``):

  call           the entry point each call drives: ``calls/<call>.py``
  payload_bytes  the size of each payload (see ``corpus.payloads``)
  payloads       how many distinct payloads, taken in turn
  align          their offsets in the corpus are multiples of it
  sample         how many answers, drawn from the seed, the check judges
                 beside the last answer of each payload
  trace_calls    calls in the ``--trace 1`` run's profiled window

A call module defines ``SPAN``, the benchmark's span around a call;
``KIND``, ``encode`` or ``decode``, which rate the calls' bytes make; and
``Call(mix, config, program, payloads)``, whose constructor does the
call's own set-up, with ``one(i)`` -> (answer, uncompressed bytes,
compressed bytes) for payload i, ``shape(i, answer)`` -> the call's shape
for the roofline counts (``rooflines/__init__.py``) and ``judge(window,
config)`` -> the checks, ``{name: (value, limit)}``.

It is a closed loop: the next call starts when the last one has returned
its bytes to the host.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time

from portbench.manifest import load_module


@dataclasses.dataclass
class Window:
    """What a window did: ``calls`` as (start, end, payload, uncompressed
    bytes, compressed bytes) on the host clock, with ``end`` None for a
    call that raised; ``sample``, answers drawn from the seed as (payload,
    answer); ``last``, each payload's last answer."""

    kind: str
    start: float
    calls: list
    sample: list
    last: dict

    @property
    def failed(self) -> int:
        return sum(c[1] is None for c in self.calls)


class Traffic:
    """The payloads of one mix at one configuration, and the call that the
    window repeats."""

    def __init__(self, mix: dict, config, program, payloads: list):
        module = load_module("calls", mix["call"])
        if module is None:
            raise ValueError(f"traffic {mix['name']}: no calls/{mix['call']}.py")
        self.mix, self.config, self.payloads = mix, config, payloads
        self.span, self.kind = module.SPAN, module.KIND
        self.call = module.Call(mix, config, program, payloads)

    def warm(self) -> None:
        """Every payload once, through the timed call."""
        for i in range(len(self.payloads)):
            self.call.one(i)

    def run(self, seed: int, seconds: float, calls: int | None = None,
            span=None, log=None) -> Window:
        """Calls back to back until ``seconds`` have passed (the call under
        way then finishes), or ``calls`` calls.  ``span(name)`` is a context
        around each call (the profiler's annotation in a traced run)."""
        k = self.mix["sample"]
        rng = random.Random(f"sample-{seed}")
        records, sample, last = [], [], {}
        start = time.perf_counter()
        deadline = start + seconds
        m = 0
        while (calls is None and time.perf_counter() < deadline) or (
                calls is not None and m < calls):
            i = m % len(self.payloads)
            t0 = time.perf_counter()
            try:
                if span is None:
                    answer, raw, packed = self.call.one(i)
                else:
                    with span(self.span):
                        answer, raw, packed = self.call.one(i)
            except Exception as e:  # a failed call counts; the run goes on
                if log:
                    log(f"call {m} on payload {i} raised {type(e).__name__}: {e}")
                records.append((t0, None, i, 0, 0))
                m += 1
                continue
            records.append((t0, time.perf_counter(), i, raw, packed))
            last[i] = answer
            j = m if m < k else rng.randrange(m + 1)
            if j < k:
                if j == len(sample):
                    sample.append((i, answer))
                else:
                    sample[j] = (i, answer)
            m += 1
        return Window(self.kind, start, records, sample, last)


def latencies_ms(window: Window) -> list:
    """Each call's latency; a call that failed counts as infinitely late."""
    return [math.inf if end is None else (end - t0) * 1e3
            for t0, end, *_ in window.calls]
