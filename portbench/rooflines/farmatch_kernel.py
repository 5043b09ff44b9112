"""The exact far matcher's match launch (window > 256): reads every byte
of the call and the lanes' lengths once, writes a distance and a length
(int32 each) at every position, as the matcher of window 256 does.  The
previous occurrences it reads are the previous launch's output, counted
there."""


def least_bytes(call: dict) -> int:
    return call["raw_bytes"] * (1 + 4 + 4) + 4 * call["lanes"]
