"""Host time a decode call blocked on copies to and from the card and on
waits for its scalars, averaged over the traced calls (ms): the
program's ``td.api.h2d`` and ``td.api.d2h`` spans (the stream or the
lanes' rows in, the error codes, the output out and, in ``decompress``,
in again for the Adler-32 and its scalars out) and the waits tallied on
the decode stages' spans (the walk's per-block reads, the expansion's
per-segment ones)."""

from portbench import decode_spans


def read(trace):
    return decode_spans.per_call(trace, decode_spans.copy_ms)
