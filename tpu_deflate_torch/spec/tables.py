"""RFC 1951 constant tables, generated from the RFC's rules.

Length and distance bases are cumulative sums of ``1 << extra_bits``; the
static Huffman codes follow the canonical-code construction.  The encoder
reads the inverse maps (length / distance -> symbol, extra value) and the
bit-reversed static codes; the plain static tokenizer reads the decode
tables.
"""

from __future__ import annotations

import numpy as np

from tpu_deflate_torch.spec.huffman import (
    build_decode_table,
    canonical_codes,
    reverse_bits,
)

# RFC 1951 3.2.7: order of the code-length code lengths in a dynamic
# block header.
CODE_LENGTH_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

# Length codes 257..285 (index 0..28); code 285 means exactly 258.
LENGTH_EXTRA_BITS = np.array(
    [0] * 8 + [1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5] + [0],
    dtype=np.int32,
)
LENGTH_BASE = np.empty(29, dtype=np.int32)
LENGTH_BASE[0] = 3
for _i in range(28):
    LENGTH_BASE[_i + 1] = LENGTH_BASE[_i] + (1 << LENGTH_EXTRA_BITS[_i])
LENGTH_BASE[28] = 258

# Distance codes 0..29.
DIST_EXTRA_BITS = np.array(
    [max(0, (_i // 2) - 1) for _i in range(30)], dtype=np.int32
)
DIST_BASE = np.empty(30, dtype=np.int32)
DIST_BASE[0] = 1
for _i in range(29):
    DIST_BASE[_i + 1] = DIST_BASE[_i] + (1 << DIST_EXTRA_BITS[_i])

MAX_MATCH = 258
MIN_MATCH = 3
MAX_DISTANCE = 32768

# Inverse maps: raw length (3..258) / distance (1..32768) -> symbol index
# and extra-bits value.
_lens = np.arange(3, MAX_MATCH + 1, dtype=np.int32)
LEN_TO_SYM = np.zeros(MAX_MATCH + 1, dtype=np.int32)
LEN_TO_SYM[3:] = np.searchsorted(LENGTH_BASE, _lens, side="right") - 1
LEN_TO_SYM[258] = 28
LEN_TO_EXTRA = np.zeros(MAX_MATCH + 1, dtype=np.int32)
LEN_TO_EXTRA[3:] = _lens - LENGTH_BASE[LEN_TO_SYM[3:]]

_dists = np.arange(1, MAX_DISTANCE + 1, dtype=np.int32)
DIST_TO_SYM = np.zeros(MAX_DISTANCE + 1, dtype=np.int32)
DIST_TO_SYM[1:] = np.searchsorted(DIST_BASE, _dists, side="right") - 1
DIST_TO_EXTRA = np.zeros(MAX_DISTANCE + 1, dtype=np.int32)
DIST_TO_EXTRA[1:] = _dists - DIST_BASE[DIST_TO_SYM[1:]]

# The fixed trees (RFC 1951 3.2.6), with bit-reversed codes that an
# LSB-first writer emits directly.
STATIC_LITLEN_LENGTHS = np.array(
    [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, dtype=np.int32
)
STATIC_LITLEN_CODES = canonical_codes(STATIC_LITLEN_LENGTHS)
STATIC_LITLEN_CODES_REV = np.array(
    [
        reverse_bits(int(c), int(n)) if n else 0
        for c, n in zip(STATIC_LITLEN_CODES, STATIC_LITLEN_LENGTHS)
    ],
    dtype=np.int32,
)

STATIC_DIST_LENGTHS = np.full(32, 5, dtype=np.int32)
STATIC_DIST_CODES = canonical_codes(STATIC_DIST_LENGTHS)
STATIC_DIST_CODES_REV = np.array(
    [reverse_bits(int(c), 5) for c in STATIC_DIST_CODES], dtype=np.int32
)

# Instant-lookup tables of the static trees (9 and 5 bits).
STATIC_LITLEN_TABLE = build_decode_table(STATIC_LITLEN_LENGTHS, 9)
STATIC_DIST_TABLE = build_decode_table(STATIC_DIST_LENGTHS, 5)
