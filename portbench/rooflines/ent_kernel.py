"""The composition of the candidate maps of a block's tiles
(``ent_from_phi``), between K1d and K3d: maps that one launch makes for
the next.  The role's bytes (the block's bits in, its tokens out) are
counted in ``k1d_kernel`` and ``k3d_kernel``, so this launch adds its
time and no bytes."""


def least_bytes(call: dict) -> int:
    return 0
