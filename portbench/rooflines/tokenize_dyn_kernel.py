"""The dynamic tokenizer of the indexed decode (``tokenize_dyn_batch``),
one lane a block: reads each static or dynamic block's bits from its
first symbol to its end once and writes each literal and each match once
as a token of three int32, 12 bytes.  The headers are parsed before it
(``mono_compact_kernel``)."""


def least_bytes(call: dict) -> int:
    bits = call["huffman_bits"] - call["header_bits"]
    return -(-bits // 8) + 12 * (call["literals"] + call["matches"])
