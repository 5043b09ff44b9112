"""Huffman blocks the device-paced walk of ``ops/foreign.py`` walked a
``decompress`` call, each ending in one device-to-host read of the
block's scalars, averaged over the traced calls: the program's
``counts["huffman_blocks"]`` on its ``td.decode.tokenize`` span.  On
stock zlib's streams it equals the Huffman blocks the reference reads
(``blocks.walk``)."""

from portbench import decode_spans


def read(trace):
    return decode_spans.per_call(trace, decode_spans.counted(("huffman_blocks",),
                                                             ("td.decode.tokenize",)))
