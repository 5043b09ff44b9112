"""The bit-pack: reads each emission once, its bit offset and its code
bits (int32 each, 8 bytes), and writes each lane's compressed bytes, as
the answer's index gives them.  The encoder emits, a lane of n bytes, the
block header, one code a position (two with dynamic trees: the length
and the distance part of a match, after a header of 340) and the
end-of-block.  Its first launch, ``mono_scatter_add_lead_kernel``, reads
part of the same entries, counted here once."""


def emissions(n: int, dynamic: bool) -> int:
    return 1 + 340 + 2 * n + 1 if dynamic else n + 2


def least_bytes(call: dict) -> int:
    C, n = call["chunk"], call["raw_bytes"]
    sizes = [min(C, n - s) for s in range(0, n, C)] or [0]
    read = sum(8 * emissions(m, call["dynamic_encode"]) for m in sizes)
    return read + sum(call["lane_bytes"])
