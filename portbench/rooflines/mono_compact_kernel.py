"""The code lengths' paint (``mono_compact``), once a dynamic header:
reads each code-length symbol's start and value once (two int32, 8
bytes) and writes each of the header's HLIT + HDIST code lengths once as
an int32, as the code tables read them."""


def least_bytes(call: dict) -> int:
    return 8 * call["cl_symbols"] + 4 * call["code_lengths"]
