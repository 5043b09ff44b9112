"""The stream's stretch between the CUDA events at the ends of the
program's ``td.decode.tokenize`` spans, a decode call, averaged over the
traced calls (ms): the block walk of ``ops/foreign.py`` with every
header parse, or the lanes' header parse and tokenizers in
``ops/decode.py``, from the stage's first work to its last, launch gaps
and the host's waits included."""

from portbench import decode_spans, spans


def read(trace):
    return decode_spans.per_call(trace, spans.card_ms("td.decode.tokenize"))
