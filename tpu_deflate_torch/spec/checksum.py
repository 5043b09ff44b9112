"""Adler-32 (RFC 1950) constants and the combine rule for concatenated
streams, which lets independently checksummed chunks merge on the host."""

from __future__ import annotations

ADLER_MOD = 65521


def adler32_combine(ad1: int, ad2: int, len2: int) -> int:
    """Checksum of concat(s1, s2) from adler32(s1), adler32(s2), len(s2).

    b(concat) = b1 + b2 + len2 * (a1 - 1) (mod m): the len2 trailing bytes
    each pick up an extra weight of sum(s1) = a1 - 1."""
    a1, b1 = ad1 & 0xFFFF, (ad1 >> 16) & 0xFFFF
    a2, b2 = ad2 & 0xFFFF, (ad2 >> 16) & 0xFFFF
    rem = len2 % ADLER_MOD
    a = (a1 + a2 - 1) % ADLER_MOD
    b = (b1 + b2 + rem * (a1 - 1)) % ADLER_MOD
    return (b << 16) | a
