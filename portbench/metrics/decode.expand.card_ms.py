"""The stream's stretch between the CUDA events at the ends of the
program's ``td.decode.expand`` spans, a decode call, averaged over the
traced calls (ms): the expansion of the tokens into bytes (the segments
of a long stream, or the lanes), launch gaps included."""

from portbench import decode_spans, spans


def read(trace):
    return decode_spans.per_call(trace, spans.card_ms("td.decode.expand"))
