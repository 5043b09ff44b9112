"""Device operations a decode call, host<->device copies left out."""

from portbench.decode_spans import calls
from portbench.trace import mean


def read(trace):
    return mean([len(c.codec_ops) for c in calls(trace)])
