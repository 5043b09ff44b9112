"""LSB-first bit writer and reader for the host reference codecs.

DEFLATE packs bits LSB-first within bytes (RFC 1951 section 3.1.1).  The
device encoder packs its bits by prefix sums and a scatter-add instead;
these classes are the host oracle it is held against.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """Accumulates bits LSB-first into a bytearray."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0  # pending bits, LSB-first
        self._nacc = 0

    @property
    def bit_length(self) -> int:
        return 8 * len(self._buf) + self._nacc

    def write_bits(self, value: int, nbits: int) -> None:
        if nbits < 0 or value < 0 or (nbits < 64 and value >> nbits):
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        self._acc |= value << self._nacc
        self._nacc += nbits
        while self._nacc >= 8:
            self._buf.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nacc -= 8

    def align_to_byte(self) -> None:
        if self._nacc:
            self._buf.append(self._acc & 0xFF)
            self._acc = 0
            self._nacc = 0

    def write_bytes(self, data: bytes) -> None:
        self.align_to_byte()
        self._buf.extend(data)

    def getvalue(self) -> bytes:
        self.align_to_byte()
        return bytes(self._buf)


class BitReader:
    """Reads bits LSB-first from a byte buffer."""

    def __init__(self, data: bytes | bytearray | np.ndarray, start_bit: int = 0) -> None:
        self._data = np.frombuffer(bytes(data), dtype=np.uint8)
        self._pos = start_bit  # absolute bit cursor

    @property
    def bit_position(self) -> int:
        return self._pos

    @property
    def byte_position(self) -> int:
        """Byte index of the next unread bit (rounded up)."""
        return (self._pos + 7) // 8

    def read_bits(self, nbits: int) -> int:
        v = self.peek_bits(nbits)
        self._pos += nbits
        return v

    def peek_bits(self, nbits: int) -> int:
        """Up to 32 bits from the cursor; bits past the end read as 0."""
        byte0 = self._pos >> 3
        shift = self._pos & 7
        acc = 0
        for k in range((shift + nbits + 7) // 8):
            i = byte0 + k
            acc |= (int(self._data[i]) if i < len(self._data) else 0) << (8 * k)
        return (acc >> shift) & ((1 << nbits) - 1)

    def align_to_byte(self) -> None:
        self._pos = (self._pos + 7) & ~7

    def read_bytes(self, n: int) -> bytes:
        self.align_to_byte()
        byte0 = self._pos >> 3
        if byte0 + n > len(self._data):
            raise EOFError("read past end of stream")
        self._pos += 8 * n
        return self._data[byte0 : byte0 + n].tobytes()

    @property
    def bits_remaining(self) -> int:
        return 8 * len(self._data) - self._pos
