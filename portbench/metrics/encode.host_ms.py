"""Host time a compress call in the program's three encode stage spans
(``td.encode.match``, ``.emit``, ``.pack``), averaged over the traced calls
(ms): the dispatch of the encode's glue and kernels."""

from portbench import spans

SPAN = "api.compress"


def read(trace):
    return spans.per_call(trace, SPAN, lambda c, r, kids: spans.host_ms(kids, spans.STAGES))
