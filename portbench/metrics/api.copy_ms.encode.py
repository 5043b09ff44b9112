"""Host time a compress call in the program's ``td.api.h2d`` and
``td.api.d2h`` spans, averaged over the traced calls (ms): the host
blocked on copies to and from the card and on the waits before them
(the checksum's scalars, the index, the body)."""

from portbench import spans

SPAN = "api.compress"


def read(trace):
    return spans.per_call(trace, SPAN, lambda c, r, kids: spans.host_ms(kids, spans.COPIES))
