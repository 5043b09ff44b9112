"""Canonical Huffman codes (RFC 1951 section 3.2.2) and full-depth decode
tables.

Decode-table entry = (symbol << 4) | nbits, nbits in 1..15, 0 == invalid.
The table is indexed with ``table_bits`` bits peeked LSB-first from the
stream; a code shorter than ``table_bits`` is replicated into every slot
that shares its low bits, so a decode is always one lookup.
"""

from __future__ import annotations

import numpy as np

MAX_CODE_BITS = 15


def reverse_bits(code: int, nbits: int) -> int:
    """Reverse the low ``nbits`` bits of ``code`` (Huffman codes go
    MSB-first on an LSB-first-packed wire)."""
    out = 0
    for _ in range(nbits):
        out = (out << 1) | (code & 1)
        code >>= 1
    return out


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """MSB-first canonical codes for ``lengths`` (0 = symbol absent)."""
    lengths = np.asarray(lengths, dtype=np.int32)
    max_bits = int(lengths.max(initial=0))
    bl_count = np.bincount(lengths, minlength=max_bits + 1).astype(np.int64)
    bl_count[0] = 0
    next_code = np.zeros(max_bits + 2, dtype=np.int64)
    code = 0
    for bits in range(1, max_bits + 1):
        code = (code + bl_count[bits - 1]) << 1
        next_code[bits] = code
    codes = np.zeros_like(lengths)
    for sym, n in enumerate(lengths):
        if n:
            codes[sym] = next_code[n]
            next_code[n] += 1
    return codes


def build_decode_table(lengths: np.ndarray, table_bits: int) -> np.ndarray:
    """Full instant-lookup decode table of ``1 << table_bits`` entries."""
    lengths = np.asarray(lengths, dtype=np.int32)
    if table_bits > MAX_CODE_BITS:
        raise ValueError(f"table_bits {table_bits} > {MAX_CODE_BITS}")
    codes = canonical_codes(lengths)
    table = np.zeros(1 << table_bits, dtype=np.int32)
    for sym, n in enumerate(lengths):
        n = int(n)
        if n == 0:
            continue
        if n > table_bits:
            raise ValueError(f"code length {n} exceeds table_bits {table_bits}")
        base = reverse_bits(int(codes[sym]), n)
        table[base :: 1 << n] = (sym << 4) | n
    return table
