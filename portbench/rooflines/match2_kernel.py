"""The LZ77 matcher (window <= 256): reads every byte of the call and the
lanes' lengths once, writes a distance and a length (int32 each) at every
position."""


def least_bytes(call: dict) -> int:
    return call["raw_bytes"] * (1 + 4 + 4) + 4 * call["lanes"]
