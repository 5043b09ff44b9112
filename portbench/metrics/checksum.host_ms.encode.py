"""Host time a compress call in the program's ``td.checksum.adler`` span,
averaged over the traced calls (ms): enqueueing the chunks' Adler-32
states and their fold, ``ops/checksum.py``."""

from portbench import spans

SPAN = "api.compress"


def read(trace):
    return spans.per_call(trace, SPAN, lambda c, r, kids: spans.host_ms(kids, spans.CHECKSUM))
