"""The dynamic trees' launch (dynamic trees): reads each position's token
start flag once and writes each lane's tables and header, int64, and its
choice (a byte).  The symbols it reads at token starts are left out: the
call's shape carries no token count, so the count is a floor."""

# literal/length codes and lengths, distance codes and lengths, header
# values and widths, 8 bytes each, and the choice
LANE_BYTES = 8 * (2 * 288 + 2 * 32 + 2 * 340) + 1


def least_bytes(call: dict) -> int:
    return call["raw_bytes"] + LANE_BYTES * call["lanes"]
