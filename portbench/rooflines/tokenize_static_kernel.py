"""The static tokenizer in the indexed decode (``decompress_indexed``
with dynamic trees allowed), where it takes the lanes whose first block
is stored, the dynamic tokenizer the lanes with Huffman codes: reads each
stored block's LEN and NLEN once (4 bytes) and writes its token once
(three int32, 12 bytes)."""


def least_bytes(call: dict) -> int:
    return 16 * call["blocks"]["stored"]
