"""Canonical Huffman codes (RFC 1951 section 3.2.2) and full-depth decode
tables.

Decode-table entry (a leaf) = (symbol << 4) | nbits, nbits in 1..15,
0 == invalid.  The table is indexed with ``table_bits`` bits peeked LSB-first from the
stream; a code shorter than ``table_bits`` is replicated into every slot
that shares its low bits, so a decode is always one lookup.
"""

from __future__ import annotations

import numpy as np

MAX_CODE_BITS = 15
LEAF_BITS_MASK = 0xF


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


def pack_leaf(symbol: int | np.ndarray, nbits: int | np.ndarray):
    return (symbol << 4) | nbits


def leaf_symbol(leaf):
    return leaf >> 4


def leaf_nbits(leaf):
    return leaf & LEAF_BITS_MASK


def build_decode_table(lengths: np.ndarray, table_bits: int | None = None) -> np.ndarray:
    """Full instant-lookup decode table of ``1 << table_bits`` entries
    (by default the longest code's length)."""
    lengths = np.asarray(lengths, dtype=np.int32)
    if table_bits is None:
        table_bits = int(lengths.max(initial=1))
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
        table[base :: 1 << n] = pack_leaf(sym, n)
    return table


def code_lengths_from_freqs(freqs: np.ndarray, max_bits: int = MAX_CODE_BITS) -> np.ndarray:
    """Length-limited Huffman code lengths of symbol frequencies, for the
    host reference encoder: plain Huffman depths, overlong leaves moved up
    to max_bits with the shallowest leaves deepened until Kraft holds,
    then the tree made complete (``_make_kraft_exact``).  A lone symbol
    gets length 1."""
    import heapq

    freqs = np.asarray(freqs, dtype=np.int64)
    n = len(freqs)
    active = [i for i in range(n) if freqs[i] > 0]
    if not active:
        return np.zeros(n, dtype=np.int32)
    if len(active) == 1:
        out = np.zeros(n, dtype=np.int32)
        out[active[0]] = 1
        return out

    heap = [(int(freqs[i]), i, ("leaf", i)) for i in active]
    heapq.heapify(heap)
    counter = n
    while len(heap) > 1:
        f1, _, t1 = heapq.heappop(heap)
        f2, _, t2 = heapq.heappop(heap)
        heapq.heappush(heap, (f1 + f2, counter, ("node", t1, t2)))
        counter += 1
    depths = np.zeros(n, dtype=np.int32)
    stack = [(heap[0][2], 0)]
    while stack:
        node, d = stack.pop()
        if node[0] == "leaf":
            depths[node[1]] = max(d, 1)
        else:
            stack.append((node[1], d + 1))
            stack.append((node[2], d + 1))

    while depths.max() > max_bits:
        depths[int(np.argmax(depths))] = max_bits
        while True:
            kraft = np.sum((depths > 0) * (2.0 ** (-depths.astype(np.float64))))
            if kraft <= 1.0 + 1e-12:
                break
            cand = np.where((depths > 0) & (depths < max_bits))[0]
            if len(cand) == 0:
                raise RuntimeError("cannot satisfy Kraft with depth limit")
            depths[cand[np.argmin(depths[cand])]] += 1
    _make_kraft_exact(depths, max_bits)
    return depths


def _make_kraft_exact(depths: np.ndarray, max_bits: int) -> None:
    """Adjust code lengths in place so sum(2^-d) == 1 (a complete tree):
    lengthen the shallowest codes while oversubscribed, then shorten the
    deepest code that does not overshoot while incomplete."""
    if depths.max(initial=0) == 0:
        return
    unit = 1 << max_bits
    total = int(np.sum((depths > 0) * (1 << (max_bits - np.minimum(depths, max_bits)))))
    while total > unit:
        cand = np.where((depths > 0) & (depths < max_bits))[0]
        i = cand[np.argmin(depths[cand])]
        total -= 1 << (max_bits - depths[i])
        depths[i] += 1
        total += 1 << (max_bits - depths[i])
    while total < unit:
        for i in np.argsort(-depths):
            if depths[i] > 1:
                gain = 1 << (max_bits - depths[i])
                if total + gain <= unit:
                    depths[i] -= 1
                    total += gain
                    break
        else:
            break
