"""The device-paced walk's token pass (K3d of ``tokenize_dyn_hier``),
once a static or dynamic block: writes each literal and each match once
as a token of three int32 (kind, value or length, distance), 12 bytes.
The block's bits are read once in ``k1d_kernel``, counted there."""


def least_bytes(call: dict) -> int:
    return 12 * (call["literals"] + call["matches"])
