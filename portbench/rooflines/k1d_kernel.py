"""The device-paced walk's candidate pass (K1d of ``tokenize_dyn_hier``),
once a static or dynamic block: reads the block's bits from its first
symbol to its end once (the call's Huffman bits less the dynamic
headers').  The candidate maps it writes are the walk's (K3d's) input,
counted there as no bytes: the role's output is the tokens."""


def least_bytes(call: dict) -> int:
    return -(-(call["huffman_bits"] - call["header_bits"]) // 8)
