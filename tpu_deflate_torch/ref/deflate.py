"""Host reference DEFLATE encoder (plain Python and numpy).

Greedy LZ77 over a hash chain with a sliding window up to 32 KiB and a
maximum match up to 258, nearer matches first and a longer one only where
it is longer, emitting one static-Huffman block or, where it is smaller,
one dynamic-Huffman block.  Byte for byte the encoder of
``tpu_deflate.ref.deflate``; the self-test decodes its streams on the
device.
"""

from __future__ import annotations

import numpy as np

from tpu_deflate_torch.config import DeflateConfig
from tpu_deflate_torch.spec import tables as T
from tpu_deflate_torch.spec.bitstream import BitWriter
from tpu_deflate_torch.spec.checksum import adler32, crc32
from tpu_deflate_torch.spec.huffman import (
    canonical_codes,
    code_lengths_from_freqs,
    reverse_bits,
)


def find_matches_greedy(data: bytes, window: int, max_match: int):
    """Greedy LZ77 tokens of data: (0, literal_byte) or (1, length,
    distance).  Each 3-byte key keeps a chain of its last 64 positions;
    the chain is walked from the most recent, within the window, and a
    match replaces the best only where it is longer."""
    n = len(data)
    tokens = []
    head: dict[bytes, list[int]] = {}
    i = 0
    while i < n:
        best_len = 0
        best_dist = 0
        if i + T.MIN_MATCH <= n:
            chain = head.get(data[i : i + T.MIN_MATCH])
            if chain:
                for j in reversed(chain):
                    d = i - j
                    if d > window:
                        break
                    limit = min(max_match, n - i)
                    ln = T.MIN_MATCH
                    while ln < limit and data[j + ln] == data[i + ln]:
                        ln += 1
                    if ln > best_len:
                        best_len = ln
                        best_dist = d
                        if ln == limit:
                            break
        if best_len >= T.MIN_MATCH:
            tokens.append((1, best_len, best_dist))
            step = best_len
        else:
            tokens.append((0, data[i]))
            step = 1
        # every covered position enters its key's chain
        for k in range(step):
            p = i + k
            if p + T.MIN_MATCH <= n:
                chain = head.setdefault(data[p : p + T.MIN_MATCH], [])
                chain.append(p)
                if len(chain) > 64:
                    del chain[0]
        i += step
    return tokens


def _token_symbols(tokens):
    """Each token as (litlen_sym, len_extra, len_ebits, dist_sym,
    dist_extra, dist_ebits), then the end-of-block symbol."""
    out = []
    for t in tokens:
        if t[0] == 0:
            out.append((t[1], 0, 0, -1, 0, 0))
        else:
            _, length, dist = t
            ls = int(T.LEN_TO_SYM[length])
            ds = int(T.DIST_TO_SYM[dist])
            out.append((
                257 + ls,
                int(T.LEN_TO_EXTRA[length]),
                int(T.LENGTH_EXTRA_BITS[ls]),
                ds,
                int(T.DIST_TO_EXTRA[dist]),
                int(T.DIST_EXTRA_BITS[ds]),
            ))
    out.append((256, 0, 0, -1, 0, 0))
    return out


def _emit_block(bw: BitWriter, syms, lit_codes_rev, lit_lens, dist_codes_rev, dist_lens):
    for (ls, lex, lexb, ds, dex, dexb) in syms:
        bw.write_bits(int(lit_codes_rev[ls]), int(lit_lens[ls]))
        if lexb:
            bw.write_bits(lex, lexb)
        if ds >= 0:
            bw.write_bits(int(dist_codes_rev[ds]), int(dist_lens[ds]))
            if dexb:
                bw.write_bits(dex, dexb)


def _rle_code_lengths(lengths: np.ndarray):
    """RFC 1951 section 3.2.7 run-length encoding of code lengths as
    (sym, extra, ebits) ops: 16 repeats the previous length 3-6 times, 17
    writes 3-10 zeros, 18 writes 11-138 zeros."""
    ops = []
    i = 0
    n = len(lengths)
    while i < n:
        v = int(lengths[i])
        run = 1
        while i + run < n and int(lengths[i + run]) == v:
            run += 1
        consumed = run
        if v == 0:
            while run >= 3:
                take = min(run, 138)
                ops.append((17, take - 3, 3) if take < 11 else (18, take - 11, 7))
                run -= take
            ops.extend((0, 0, 0) for _ in range(run))
        else:
            ops.append((v, 0, 0))
            run -= 1
            while run >= 3:
                take = min(run, 6)
                ops.append((16, take - 3, 2))
                run -= take
            ops.extend((v, 0, 0) for _ in range(run))
        i += consumed
    return ops


def _rev_codes(lengths) -> np.ndarray:
    """Bit-reversed canonical codes of ``lengths`` (0 for unused)."""
    codes = canonical_codes(lengths)
    return np.array([reverse_bits(int(c), int(ln)) if ln else 0
                     for c, ln in zip(codes, lengths)], dtype=np.int64)


def _emit_dynamic_header(bw: BitWriter, lit_lengths, dist_lengths):
    hlit = max(257, int(np.max(np.nonzero(lit_lengths)[0], initial=256) + 1))
    nz_dist = np.nonzero(dist_lengths)[0]
    hdist = max(1, int(nz_dist.max() + 1) if len(nz_dist) else 1)
    ops = _rle_code_lengths(np.concatenate([lit_lengths[:hlit], dist_lengths[:hdist]]))
    cl_freq = np.zeros(19, dtype=np.int64)
    for sym, _, _ in ops:
        cl_freq[sym] += 1
    cl_lengths = code_lengths_from_freqs(cl_freq, max_bits=7)
    cl_rev = _rev_codes(cl_lengths)
    # HCLEN: the code-length code lengths sent in RFC order, at least 4
    order = T.CODE_LENGTH_ORDER
    used = 19
    while used > 4 and cl_lengths[order[used - 1]] == 0:
        used -= 1
    bw.write_bits(hlit - 257, 5)
    bw.write_bits(hdist - 1, 5)
    bw.write_bits(used - 4, 4)
    for i in range(used):
        bw.write_bits(int(cl_lengths[order[i]]), 3)
    for sym, extra, ebits in ops:
        bw.write_bits(int(cl_rev[sym]), int(cl_lengths[sym]))
        if ebits:
            bw.write_bits(extra, ebits)
    return cl_lengths


def deflate_raw(
    data: bytes,
    config: DeflateConfig = DeflateConfig(),
    final: bool = True,
    byte_align: bool = False,
) -> bytes:
    """A raw DEFLATE stream of one block.  With ``byte_align=True`` and
    ``final=False`` an empty stored block ends it on a byte boundary, so
    independently encoded chunks concatenate bytewise."""
    bw = BitWriter()
    syms = _token_symbols(find_matches_greedy(data, config.window, config.max_match))

    use_dynamic = False
    if config.dynamic_encode and len(data) >= 64:
        lit_freq = np.zeros(286, dtype=np.int64)
        dist_freq = np.zeros(30, dtype=np.int64)
        for (ls, _, _, ds, _, _) in syms:
            lit_freq[ls] += 1
            if ds >= 0:
                dist_freq[ds] += 1
        lit_lengths = code_lengths_from_freqs(lit_freq, 15)
        dist_lengths = code_lengths_from_freqs(dist_freq, 15)
        if len(np.nonzero(dist_lengths)[0]) == 0:
            dist_lengths[0] = 1  # RFC 1951 wants one distance code at least
        static_bits = sum(
            int(T.STATIC_LITLEN_LENGTHS[ls]) + lexb + (5 + dexb if ds >= 0 else 0)
            for (ls, _, lexb, ds, _, dexb) in syms
        )
        dyn_bits = sum(
            int(lit_lengths[ls]) + lexb
            + (int(dist_lengths[ds]) + dexb if ds >= 0 else 0)
            for (ls, _, lexb, ds, _, dexb) in syms
        ) + 200  # the header, roughly
        use_dynamic = dyn_bits < static_bits

    bw.write_bits(1 if final else 0, 1)
    if use_dynamic:
        bw.write_bits(2, 2)
        _emit_dynamic_header(bw, lit_lengths, dist_lengths)
        _emit_block(bw, syms, _rev_codes(lit_lengths), lit_lengths,
                    _rev_codes(dist_lengths), dist_lengths)
    else:
        bw.write_bits(1, 2)
        _emit_block(bw, syms, T.STATIC_LITLEN_CODES_REV, T.STATIC_LITLEN_LENGTHS,
                    T.STATIC_DIST_CODES_REV, T.STATIC_DIST_LENGTHS)

    if byte_align and not final:
        # empty non-final stored block: header 000, align, LEN=0, NLEN=~0
        bw.write_bits(0, 3)
        bw.align_to_byte()
        bw.write_bytes(b"\x00\x00\xff\xff")
    return bw.getvalue()


def zlib_compress(data: bytes, config: DeflateConfig = DeflateConfig()) -> bytes:
    """RFC 1950: header 78 9c, the DEFLATE body, big-endian Adler-32."""
    body = deflate_raw(data, config, final=True)
    return b"\x78\x9c" + body + adler32(data).to_bytes(4, "big")


def gzip_compress(data: bytes, config: DeflateConfig = DeflateConfig()) -> bytes:
    """RFC 1952, one member."""
    body = deflate_raw(data, config, final=True)
    header = b"\x1f\x8b\x08\x00" + b"\x00\x00\x00\x00" + b"\x00\xff"
    trailer = crc32(data).to_bytes(4, "little") + (len(data) & 0xFFFFFFFF).to_bytes(
        4, "little"
    )
    return header + body + trailer
