"""Adler-32 (RFC 1950) and CRC-32 (RFC 1952) on the host, and the
Adler-32 combine rule for concatenated streams, which lets independently
checksummed chunks merge on the host."""

from __future__ import annotations

import zlib

import numpy as np

ADLER_MOD = 65521


def adler32(data: bytes | np.ndarray, value: int = 1) -> int:
    """Adler-32 of data continuing from ``value``, as weighted sums:
    a = a0 + sum(d), b = b0 + n * a0 + sum((n - i) * d[i]) (mod 65521)."""
    d = np.frombuffer(bytes(data), dtype=np.uint8).astype(np.int64)
    n = len(d)
    a0 = value & 0xFFFF
    b0 = (value >> 16) & 0xFFFF
    a = (a0 + int(d.sum())) % ADLER_MOD
    w = np.arange(n, 0, -1, dtype=np.int64)
    b = (b0 + n * a0 + int((w * d).sum())) % ADLER_MOD
    return (b << 16) | a


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


def crc32(data: bytes, value: int = 0) -> int:
    return zlib.crc32(data, value) & 0xFFFFFFFF
