"""A compress call's wall time less the time the card was busy within it,
averaged over the traced calls (ms): the host's share of a call in the
API layer (chunking, copies, enqueueing, assembling the stream)."""

from portbench.trace import mean

SPAN = "api.compress"


def read(trace):
    return mean([c.wall_ms - c.busy_ms for c in trace.of(SPAN)])
