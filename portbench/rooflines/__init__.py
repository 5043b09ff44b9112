"""Each hand kernel's least time: the bytes its role must read once and
write once for one call, over the card's published memory rate.

``rooflines/<kernel>.py`` defines ``least_bytes(call) -> int`` for the
kernel of that name in the trace (the function name of its ``__global__``
definition).  ``call`` is the call's shape, made by the benchmark from its
own inputs and the answer's sizes, never from the program's state:

  lanes, chunk       chunks in the call and the configuration's chunk size
  raw_bytes          uncompressed bytes of the call
  window, max_match, dynamic_encode   the configuration's fields
  lane_bytes         (compress calls) each lane's compressed bytes, from
                     the answer's index

Every kernel the program's CUDA sources define is bound by bytes in
``PERF.md``'s kernel table, so the least time is bytes over the rate.
"""

from __future__ import annotations

import sys

from portbench.manifest import load_module

_cache = {}


def least_bytes(kernel: str, call: dict):
    """The kernel's least bytes for the call, or None with no file for it."""
    if kernel not in _cache:
        _cache[kernel] = load_module("rooflines", kernel)
        if _cache[kernel] is None:
            print(f"portbench: no rooflines/{kernel}.py; its time counts with "
                  f"no bytes", file=sys.stderr)
    module = _cache[kernel]
    return None if module is None else module.least_bytes(call)


def share(calls: list, hand: set, peak: dict | None):
    """Summed least time over summed device time of the hand kernels the
    calls launched, in percent; None where they launched none or the card
    has no entry in ``peaks.json``."""
    if peak is None:
        return None
    least = spent = 0.0
    for c in calls:
        for kernel, us in c.kernel_us(hand).items():
            spent += us * 1e-6
            nbytes = least_bytes(kernel, c.shape)
            least += (nbytes or 0) / peak["hbm_bytes_per_s"]
    return 100 * least / spent if spent > 0 else None
