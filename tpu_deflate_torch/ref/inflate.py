"""Host reference DEFLATE decoder (plain Python and numpy), and the typed
error for corrupt or unsupported compressed input.

Stored, static and dynamic blocks, multi-block streams and the full
32 KiB window, by a table-driven loop over full-depth decode tables
(``spec.huffman.build_decode_table``).  The same outputs and error texts
as ``tpu_deflate.ref.inflate``.
"""

from __future__ import annotations

import numpy as np

from tpu_deflate_torch.spec import tables as T
from tpu_deflate_torch.spec.bitstream import BitReader
from tpu_deflate_torch.spec.checksum import adler32, crc32
from tpu_deflate_torch.spec.huffman import build_decode_table, leaf_nbits, leaf_symbol


class DeflateError(ValueError):
    pass


def _read_symbol(br: BitReader, table: np.ndarray, table_bits: int) -> int:
    leaf = int(table[br.peek_bits(table_bits)])
    n = leaf_nbits(leaf)
    if n == 0:
        raise DeflateError("invalid Huffman code")
    br._pos += n
    return leaf_symbol(leaf)


def _read_dynamic_tables(br: BitReader):
    """A dynamic block header (RFC 1951 section 3.2.7): (lit_table,
    lit_bits, dist_table, dist_bits)."""
    hlit = br.read_bits(5) + 257
    hdist = br.read_bits(5) + 1
    hclen = br.read_bits(4) + 4
    cl_lengths = np.zeros(19, dtype=np.int32)
    for i in range(hclen):
        cl_lengths[T.CODE_LENGTH_ORDER[i]] = br.read_bits(3)
    cl_bits = int(cl_lengths.max(initial=1))
    cl_table = build_decode_table(cl_lengths, cl_bits)

    lengths = np.zeros(hlit + hdist, dtype=np.int32)
    i = 0
    while i < hlit + hdist:
        sym = _read_symbol(br, cl_table, cl_bits)
        if sym < 16:
            lengths[i] = sym
            i += 1
        elif sym == 16:  # repeat the previous length 3-6 times
            if i == 0:
                raise DeflateError("repeat with no previous length")
            rep = 3 + br.read_bits(2)
            lengths[i : i + rep] = lengths[i - 1]
            i += rep
        elif sym == 17:  # 3-10 zeros
            i += 3 + br.read_bits(3)
        else:  # 18: 11-138 zeros
            i += 11 + br.read_bits(7)
    if i > hlit + hdist:
        raise DeflateError("code length repeat overflow")

    lit_lengths = lengths[:hlit]
    dist_lengths = lengths[hlit:]
    lit_bits = int(lit_lengths.max(initial=1))
    dist_bits = int(dist_lengths.max(initial=1))
    return (build_decode_table(lit_lengths, lit_bits), lit_bits,
            build_decode_table(dist_lengths, dist_bits), dist_bits)


def inflate_raw(data: bytes, start_bit: int = 0, max_output: int | None = None):
    """Decode a raw DEFLATE stream from ``start_bit``.  Returns (output
    bytes, end bit position)."""
    br = BitReader(data, start_bit)
    out = bytearray()
    while True:
        bfinal = br.read_bits(1)
        method = br.read_bits(2)
        if method == 0:  # stored
            br.align_to_byte()
            ln = int.from_bytes(br.read_bytes(2), "little")
            nln = int.from_bytes(br.read_bytes(2), "little")
            if ln != (~nln & 0xFFFF):
                raise DeflateError("stored block LEN/NLEN mismatch")
            out.extend(br.read_bytes(ln))
        elif method in (1, 2):
            if method == 1:
                lit_table, lit_bits = T.STATIC_LITLEN_TABLE, 9
                dist_table, dist_bits = T.STATIC_DIST_TABLE, 5
            else:
                lit_table, lit_bits, dist_table, dist_bits = _read_dynamic_tables(br)
            while True:
                sym = _read_symbol(br, lit_table, lit_bits)
                if sym < 256:
                    out.append(sym)
                elif sym == 256:
                    break
                else:
                    li = sym - 257
                    if li >= 29:
                        raise DeflateError(f"bad length symbol {sym}")
                    length = int(T.LENGTH_BASE[li]) + br.read_bits(
                        int(T.LENGTH_EXTRA_BITS[li]))
                    dsym = _read_symbol(br, dist_table, dist_bits)
                    if dsym >= 30:
                        raise DeflateError(f"bad distance symbol {dsym}")
                    dist = int(T.DIST_BASE[dsym]) + br.read_bits(
                        int(T.DIST_EXTRA_BITS[dsym]))
                    if dist > len(out):
                        raise DeflateError("distance too far back")
                    # an overlapping copy is byte after byte by definition
                    start = len(out) - dist
                    for k in range(length):
                        out.append(out[start + k])
                if max_output is not None and len(out) > max_output:
                    raise DeflateError("output larger than limit")
        else:
            raise DeflateError("reserved block method 3")
        if bfinal:
            break
    return bytes(out), br.bit_position


def zlib_decompress(data: bytes) -> bytes:
    """RFC 1950: header checks, inflate, Adler-32 verified."""
    if len(data) < 6:
        raise DeflateError("zlib stream too short")
    cmf, flg = data[0], data[1]
    if cmf & 0x0F != 8:
        raise DeflateError("unsupported compression method")
    if (cmf << 8 | flg) % 31 != 0:
        raise DeflateError("bad zlib header check")
    if flg & 0x20:
        raise DeflateError("preset dictionary not supported")
    out, end_bit = inflate_raw(data, start_bit=16)
    trailer_at = (end_bit + 7) // 8
    if trailer_at + 4 > len(data):
        raise DeflateError("missing Adler-32 trailer")
    expect = int.from_bytes(data[trailer_at : trailer_at + 4], "big")
    got = adler32(out)
    if got != expect:
        raise DeflateError(f"Adler-32 mismatch: {got:#x} != {expect:#x}")
    return out


def gzip_decompress(data: bytes) -> bytes:
    """RFC 1952, one member or several: inflate each, CRC-32 and ISIZE
    verified."""
    out_all = bytearray()
    pos = 0
    while pos < len(data):
        if data[pos : pos + 2] != b"\x1f\x8b":
            raise DeflateError("bad gzip magic")
        if data[pos + 2] != 8:
            raise DeflateError("unsupported gzip method")
        flg = data[pos + 3]
        p = pos + 10
        if flg & 0x04:  # FEXTRA
            p += 2 + int.from_bytes(data[p : p + 2], "little")
        if flg & 0x08:  # FNAME
            p = data.index(b"\x00", p) + 1
        if flg & 0x10:  # FCOMMENT
            p = data.index(b"\x00", p) + 1
        if flg & 0x02:  # FHCRC
            p += 2
        out, end_bit = inflate_raw(data, start_bit=8 * p)
        p = (end_bit + 7) // 8
        expect_crc = int.from_bytes(data[p : p + 4], "little")
        expect_isize = int.from_bytes(data[p + 4 : p + 8], "little")
        if crc32(bytes(out)) != expect_crc:
            raise DeflateError("gzip CRC-32 mismatch")
        if (len(out) & 0xFFFFFFFF) != expect_isize:
            raise DeflateError("gzip ISIZE mismatch")
        out_all.extend(out)
        pos = p + 8
    return bytes(out_all)
