"""Host time a decode call in the program's ``td.checksum.adler`` span,
averaged over the traced calls (ms): the Adler-32 check, enqueued on the
card in ``decompress`` (``ops/checksum.py``; the wait for its scalars is
a ``td.api.d2h``), ``zlib.adler32`` over the output on the host in
``decompress_indexed``."""

from portbench import decode_spans, spans


def read(trace):
    return decode_spans.per_call(trace, lambda c, r, kids: spans.host_ms(kids, spans.CHECKSUM))
