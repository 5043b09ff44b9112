"""The hand kernels' summed least time over their summed device time in
the traced compress calls (%), each kernel's least time counted by
``rooflines/<kernel>.py`` against the card's memory rate in
``peaks.json``."""

from portbench import rooflines

SPAN = "api.compress"


def read(trace):
    return rooflines.share(trace.of(SPAN), trace.hand, trace.peak)
