"""The host time of the program's root span of a compress call less its
children's, averaged over the traced calls (ms): ``api.py``'s own code
(the chunk padding, the stream's assembly, its Python), read from the
program's spans (``spans.py``)."""

from portbench import spans

SPAN = "api.compress"


def read(trace):
    return spans.per_call(trace, SPAN, spans.self_ms)
