"""The code lengths' reachability chase (``visited_from_adv``), once a
dynamic header: reads the header's bits once, from the block's first bit
to its first symbol.  The code lengths are written by
``mono_compact_kernel``, counted there."""


def least_bytes(call: dict) -> int:
    return -(-call["header_bits"] // 8)
