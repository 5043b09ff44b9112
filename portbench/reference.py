"""The benchmark's plain reference: a DEFLATE decoder (RFC 1951) and
Adler-32 (RFC 1950), in Python and numpy.

Written from the RFCs for this benchmark; it imports nothing of the program
under test.  ``inflate_lane`` decodes one lane of an indexed stream with an
empty history, so a match that reaches before the lane fails, and reports
what the checks compare beside the bytes: where the lane ended, whether its
last block was final, its longest match and farthest distance, and its
blocks by type.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# RFC 1951 3.2.5: length codes 257..285 and distance codes 0..29
LEN_EXTRA = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
LEN_BASE = [3]
for _e in LEN_EXTRA[:-2]:
    LEN_BASE.append(LEN_BASE[-1] + (1 << _e))
LEN_BASE.append(258)
DIST_EXTRA = [0, 0] + [i // 2 - 1 for i in range(2, 30)]
DIST_BASE = [1]
for _e in DIST_EXTRA[:-1]:
    DIST_BASE.append(DIST_BASE[-1] + (1 << _e))
CL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
STATIC_LIT = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
STATIC_DIST = [5] * 30

STORED, STATIC, DYNAMIC = 0, 1, 2


class InflateError(ValueError):
    pass


@dataclasses.dataclass
class Lane:
    """What a lane decoded to: ``data``; ``end_bit``, the bit after its last
    block; ``final``, that block's BFINAL; ``max_len`` / ``max_dist`` over
    its matches; ``blocks``, the count of each block type."""

    data: bytes
    end_bit: int
    final: bool
    max_len: int
    max_dist: int
    blocks: tuple


def decode_table(lengths):
    """A full-depth table for LSB-first peeks of ``max(lengths)`` bits:
    entry (symbol << 4) | code length, 0 where no code starts."""
    nbits = max(lengths)
    if nbits == 0:
        return [0], 0
    count = [0] * 16
    for n in lengths:
        count[n] += 1
    count[0] = 0
    code, nxt = 0, [0] * 16
    for n in range(1, 16):
        code = (code + count[n - 1]) << 1
        nxt[n] = code
    if sum(count[n] << (15 - n) for n in range(1, 16)) > 1 << 15:
        raise InflateError("oversubscribed code")
    table = [0] * (1 << nbits)
    for sym, n in enumerate(lengths):
        if n == 0:
            continue
        c, nxt[n] = nxt[n], nxt[n] + 1
        rev = int(f"{c:0{n}b}"[::-1], 2)
        for k in range(rev, 1 << nbits, 1 << n):
            table[k] = (sym << 4) | n
    return table, nbits


_STATIC = (decode_table(STATIC_LIT), decode_table(STATIC_DIST))


def _windows(buf: bytes) -> list:
    """The little-endian 32-bit word at every byte of buf (zeros past it)."""
    b = np.frombuffer(buf + bytes(8), np.uint8).astype(np.uint32)
    n = len(buf) + 4
    return (b[:n] | b[1 : n + 1] << 8 | b[2 : n + 2] << 16 | b[3 : n + 3] << 24).tolist()


def inflate_lane(buf: bytes) -> Lane:
    """Decode blocks of ``buf`` from its first bit until a final block or
    until the next block would start at or past the end of ``buf``."""
    try:
        return _inflate(buf)
    except IndexError:
        raise InflateError("the lane runs past its bytes") from None


def _inflate(buf: bytes) -> Lane:
    W = _windows(buf)
    nbits = 8 * len(buf)
    out = bytearray()
    p = max_len = max_dist = 0
    blocks = [0, 0, 0]
    final = False

    def bits(n):
        nonlocal p
        v = (W[p >> 3] >> (p & 7)) & ((1 << n) - 1)
        p += n
        return v

    while p < nbits and not final:
        final = bool(bits(1))
        btype = bits(2)
        if btype == STORED:
            p = (p + 7) & ~7
            size, nsize = bits(16), bits(16)
            if size != nsize ^ 0xFFFF:
                raise InflateError("stored block length check")
            if p + 8 * size > nbits:
                raise InflateError("stored block past the end")
            out += buf[p >> 3 : (p >> 3) + size]
            p += 8 * size
            blocks[STORED] += 1
            continue
        if btype == STATIC:
            (lt, lb), (dt, db) = _STATIC
        elif btype == DYNAMIC:
            hlit, hdist, hclen = bits(5) + 257, bits(5) + 1, bits(4) + 4
            cl = [0] * 19
            for i in range(hclen):
                cl[CL_ORDER[i]] = bits(3)
            ct, cb = decode_table(cl)
            lengths = []
            while len(lengths) < hlit + hdist:
                e = ct[(W[p >> 3] >> (p & 7)) & ((1 << cb) - 1)]
                if not e:
                    raise InflateError("bad code-length code")
                p += e & 15
                sym = e >> 4
                if sym < 16:
                    lengths.append(sym)
                elif sym == 16:
                    if not lengths:
                        raise InflateError("repeat with no previous length")
                    lengths += [lengths[-1]] * (3 + bits(2))
                else:
                    lengths += [0] * (3 + bits(3) if sym == 17 else 11 + bits(7))
            if len(lengths) > hlit + hdist or lengths[256] == 0:
                raise InflateError("bad code lengths")
            (lt, lb), (dt, db) = decode_table(lengths[:hlit]), decode_table(lengths[hlit:])
        else:
            raise InflateError("block type 3")
        blocks[btype] += 1
        lmask, dmask = (1 << lb) - 1, (1 << db) - 1
        while True:
            e = lt[(W[p >> 3] >> (p & 7)) & lmask]
            if not e:
                raise InflateError("bad literal/length code")
            p += e & 15
            sym = e >> 4
            if sym < 256:
                out.append(sym)
                continue
            if sym == 256:
                break
            i = sym - 257
            if i > 28:
                raise InflateError("bad length symbol")
            length = LEN_BASE[i] + bits(LEN_EXTRA[i])
            e = dt[(W[p >> 3] >> (p & 7)) & dmask] if db else 0
            if not e or e >> 4 > 29:
                raise InflateError("bad distance code")
            p += e & 15
            ds = e >> 4
            dist = DIST_BASE[ds] + bits(DIST_EXTRA[ds])
            if dist > len(out):
                raise InflateError("distance before the lane")
            max_len, max_dist = max(max_len, length), max(max_dist, dist)
            s = len(out) - dist
            if dist >= length:
                out += out[s : s + length]
            else:
                out += (out[s:] * (length // dist + 1))[:length]
        if p > nbits:
            raise InflateError("block runs past the end")
    return Lane(bytes(out), p, final, max_len, max_dist, tuple(blocks))


def adler32(data: bytes) -> int:
    """Adler-32 (RFC 1950 8.2) by sums over blocks of 2^20 bytes."""
    a, b = 1, 0
    x = np.frombuffer(data, np.uint8).astype(np.int64)
    for s in range(0, len(x), 1 << 20):
        blk = x[s : s + (1 << 20)]
        n = len(blk)
        b = (b + n * a + int(((n - np.arange(n)) * blk).sum())) % 65521
        a = (a + int(blk.sum())) % 65521
    return (b << 16) | a
