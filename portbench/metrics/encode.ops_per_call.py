"""Device operations a compress call, host<->device copies left out."""

from portbench.trace import mean

SPAN = "api.compress"


def read(trace):
    return mean([len(c.codec_ops) for c in trace.of(SPAN)])
