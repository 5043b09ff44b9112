"""The host time of the program's root span of a decode call
(``td.api.decompress`` or ``td.api.decompress_indexed``) less its
children's, averaged over the traced calls (ms): ``api.py``'s own code
(the lanes' rows padded and cut, the output's mask, its Python)."""

from portbench import decode_spans, spans


def read(trace):
    return decode_spans.per_call(trace, spans.self_ms)
