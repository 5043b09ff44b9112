"""Card idle a compress call inside the program's three encode stage
spans, averaged over the traced calls (ms): each span set on the trace's
clock, less the union of the call's device operations within it."""

from portbench import spans

SPAN = "api.compress"


def read(trace):
    return spans.per_call(trace, SPAN, spans.idle_ms)
