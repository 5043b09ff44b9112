"""The hand kernels' summed least time over their summed device time in
the traced decode calls (%), each kernel's least time counted by
``rooflines/<kernel>.py`` from the call's shape (the benchmark's own
reading of its stream, ``blocks.py``) against the card's memory rate in
``peaks.json``."""

from portbench import rooflines
from portbench.decode_spans import calls


def read(trace):
    return rooflines.share(calls(trace), trace.hand, trace.peak)
