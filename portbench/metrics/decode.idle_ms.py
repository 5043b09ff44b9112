"""Card idle a decode call inside the program's two decode stage spans
(``td.decode.tokenize``, ``td.decode.expand``), averaged over the traced
calls (ms): each span set on the trace's clock, less the union of the
call's device operations within it."""

from portbench import decode_spans


def read(trace):
    return decode_spans.per_call(trace, decode_spans.idle_ms)
