"""The lanes' expansion (``expand_fused3``): reads each token once (three
int32, 12 bytes, one a stored block) and each stored byte once, and
writes each output byte once."""


def least_bytes(call: dict) -> int:
    tokens = call["literals"] + call["matches"] + call["blocks"]["stored"]
    return 12 * tokens + call["stored_bytes"] + call["raw_bytes"]
