"""The exact far matcher's keys launch: reads every byte of the call and
the lanes' lengths once, writes three int32 keys at every position (the
3-byte key and the 6- and 10-byte hashes) for the sort."""


def least_bytes(call: dict) -> int:
    return call["raw_bytes"] * (1 + 3 * 4) + 4 * call["lanes"]
