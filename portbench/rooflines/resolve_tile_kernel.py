"""The expansion of a long stream's segments that hold a stored token
(``resolve_roots``, its first launch): reads each token once (three
int32, 12 bytes, one a stored block) and each stored byte once, and
writes each output byte once.  Where the call has no stored block the
segments take ``expand_fused2``, which counts the role."""


def least_bytes(call: dict) -> int:
    if not call["blocks"]["stored"]:
        return 0
    tokens = call["literals"] + call["matches"] + call["blocks"]["stored"]
    return 12 * tokens + call["stored_bytes"] + call["raw_bytes"]
