"""The expansion of a long stream's segments (``expand_fused2``): reads
each token once (three int32, 12 bytes) and writes each output byte
once.  A segment with a stored token takes ``resolve_roots`` instead, so
a call with a stored block counts the role there
(``resolve_tile_kernel``) and this launch's time with no bytes; the
32 KiB of output each segment carries in as literals are the design's,
not the role's."""


def least_bytes(call: dict) -> int:
    if call["blocks"]["stored"]:
        return 0
    return 12 * (call["literals"] + call["matches"]) + call["raw_bytes"]
