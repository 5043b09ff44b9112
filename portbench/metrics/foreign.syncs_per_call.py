"""Waits of a ``decompress`` call's device-paced walk and segmented
expansion (``ops/foreign.py``) for the card, averaged over the traced
calls: each upload that waits for the stream and each device-to-host read
that the program tallies on its ``td.decode.tokenize`` and
``td.decode.expand`` spans (``counts["h2d_n"]`` and ``counts["d2h_n"]``).
The walk's share is one a Huffman block, the read of its scalars; an
upload that does not wait is not tallied."""

from portbench import decode_spans


def read(trace):
    return decode_spans.per_call(trace, decode_spans.counted(decode_spans.SYNCS,
                                                             decode_spans.STAGES))
