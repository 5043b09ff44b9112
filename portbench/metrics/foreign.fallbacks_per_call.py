"""Walks of ``ops/foreign.py`` that reported FALLBACK, sending the stream
to the general pipeline, a ``decompress`` call, averaged over the traced
calls: the program's ``counts["fallback"]`` on its ``td.decode.tokenize``
spans.  0 on stock zlib's default streams."""

from portbench import decode_spans


def read(trace):
    return decode_spans.per_call(trace, decode_spans.counted(("fallback",),
                                                             ("td.decode.tokenize",)))
