"""The exact far matcher's previous-occurrence launch: reads each of the
three sorted keys of a position (int32) and its place in the order
(int64, as torch.sort gives it) once, writes each key's previous
occurrence (int32)."""


def least_bytes(call: dict) -> int:
    return call["raw_bytes"] * 3 * (4 + 8 + 4)
