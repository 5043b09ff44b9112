"""Public compress / decompress API over the device encoder and decoder.

The input is split into fixed-size chunks; every chunk is encoded on the
device as an independent byte-aligned DEFLATE block run, and the chunks
concatenate bytewise into one RFC 1950 stream whose Adler-32 is folded
from per-chunk states.  The indexed form also returns each chunk's
compressed size, which lets ``decompress_indexed`` decode every chunk as
its own lane.  ``compress_gzip`` wraps the same body in one gzip member;
``compress_gzip_members`` makes each chunk a self-indexing gzip member,
which ``decompress_gzip`` decodes as lanes (any other gzip member by
member).  ``StreamCompressor`` and ``StreamDecompressor`` are the
incremental forms.  Streams are byte-identical to the JAX package's.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from tpu_deflate_torch.config import DeflateConfig
from tpu_deflate_torch.ops.checksum import adler32_fold_states, adler32_state
from tpu_deflate_torch.ops.decode import (
    ERR_DYNAMIC,
    decode_rows_batch,
    inflate_device,
    inflate_stream_step,
    zlib_decompress_device,
)
from tpu_deflate_torch.ops.encode import encode_blocks_batch
from tpu_deflate_torch.ref.inflate import DeflateError
from tpu_deflate_torch.utils.profiling import span

_ZLIB_HEADER = b"\x78\x9c"


def _chunk(data: bytes, chunk_size: int):
    """(uint8[B, chunk_size] zero-padded chunks, int32[B] lengths)."""
    n = len(data)
    nchunks = max(1, -(-n // chunk_size))
    padded = np.zeros(nchunks * chunk_size, dtype=np.uint8)
    padded[:n] = np.frombuffer(data, dtype=np.uint8)
    lengths = np.clip(n - np.arange(nchunks) * chunk_size, 0, chunk_size)
    return padded.reshape(nchunks, chunk_size), lengths.astype(np.int32)


def deflate_device(data: bytes, config: DeflateConfig = DeflateConfig(),
                   device="cuda"):
    """Encode on ``device``; returns (chunks uint8[B, M], out_lens
    int32[B], adler) with chunks and out_lens on the device.
    ``config.one_block`` encodes the whole input as a single chunk."""
    chunk_size = config.chunk_size
    if config.one_block:
        chunk_size = max(chunk_size, 1 << int(np.ceil(np.log2(max(len(data), 2)))))
    arr, lengths = _chunk(data, chunk_size)
    with span("td.api.h2d"):
        chunks = torch.from_numpy(arr).to(device)
        lens = torch.from_numpy(lengths).to(device)
        finals = torch.zeros(len(lengths), dtype=torch.bool, device=device)
        finals[-1] = True
    out, out_lens, _ = encode_blocks_batch(chunks, lens, finals, config)
    with span("td.checksum.adler"):
        a, b = adler32_state(chunks, lens)
        fa, fb, _ = adler32_fold_states(a, b, lens)
    # the call's first wait on the card: the fold's scalars come after the
    # whole encode on the stream
    with span("td.api.d2h"):
        adler = (int(fb) << 16) | int(fa)
    return out, out_lens, adler


def _body(out: torch.Tensor, out_lens: torch.Tensor) -> bytes:
    """The lanes' bytes, in order: a DEFLATE body."""
    keep = torch.arange(out.shape[1], device=out.device) < out_lens[:, None]
    with span("td.api.d2h"):
        body = out[keep].cpu()
    return body.numpy().tobytes()  # row-major: chunks in order


def _stream(out: torch.Tensor, out_lens: torch.Tensor, adler: int) -> bytes:
    return _ZLIB_HEADER + _body(out, out_lens) + adler.to_bytes(4, "big")


def compress(data: bytes, config: DeflateConfig = DeflateConfig(),
             device="cuda") -> bytes:
    """zlib-compatible compress on ``device``."""
    if not config.compress:
        raise ValueError("config disables compress")
    with span("td.api.compress"):
        return _stream(*deflate_device(data, config, device))


def decompress(data: bytes, config: DeflateConfig = DeflateConfig(),
               device="cuda") -> bytes:
    """zlib-compatible decompress on ``device`` of any zlib stream, as one
    lane; raises DeflateError on a corrupt stream."""
    if not config.decompress:
        raise ValueError("config disables decompress")
    with span("td.api.decompress"):
        return zlib_decompress_device(data, config, device)


def compress_indexed(data: bytes, config: DeflateConfig = DeflateConfig(),
                     device="cuda"):
    """Compress and return (zlib stream, int64 compressed size of each
    chunk).  The index is a sidecar: any zlib reads the stream alone."""
    with span("td.api.compress_indexed"):
        out, out_lens, adler = deflate_device(data, config, device)
        with span("td.api.d2h"):
            index = out_lens.cpu().numpy().astype(np.int64)
        return _stream(out, out_lens, adler), index


def decompress_indexed(stream: bytes, index, config: DeflateConfig = DeflateConfig(),
                       device="cuda") -> bytes:
    """Chunk-parallel decompress of an indexed stream, one lane per chunk;
    verifies the Adler-32 trailer.

    Every chunk starts byte-aligned, so lane i is the body from the
    index's i-th offset on, up to an end bit 8 * index[i] after it.  As in
    the JAX package, which reads every lane from one body buffer, a lane
    may read on into the next one's bytes, and a negative entry is no
    error: a lane that would start before the body starts at its first
    byte, and a lane whose end comes before its start is empty.  Raises
    ValueError on a corrupt stream or an index that does not cover it,
    OverflowError on an index of no chunk (the JAX package's type), and
    the errors of ``_decode_lanes``."""
    with span("td.api.decompress_indexed"):
        body = stream[2:-4]
        index = np.asarray(index, dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(index)])
        if offsets[-1] != len(body):
            raise ValueError("index does not cover the stream body")
        if len(index) == 0:  # the JAX package's batch pad overflows here
            raise OverflowError("decompress_indexed: the index has no chunk")
        starts = np.clip(offsets[:-1], 0, len(body))
        outs, totals = _decode_lanes(body, starts, index,
                                     max(int(index.max(initial=0)), 1), config, device)
        keep = torch.arange(outs.shape[1], device=outs.device) < totals[:, None]
        with span("td.api.d2h"):
            result = outs[keep].cpu().numpy().tobytes()
        with span("td.checksum.adler"):
            adler = zlib.adler32(result)
        if adler != int.from_bytes(stream[-4:], "big"):
            raise ValueError("Adler-32 mismatch")
        return result


def _decode_lanes(src: bytes, starts: np.ndarray, sizes: np.ndarray, width: int,
                  config: DeflateConfig, device):
    """Decode chunk lanes of src on ``device``: lane i is the width bytes
    of src from byte starts[i] on (zero past src), ending at bit
    8 * sizes[i], and stops at its first end-of-block.  Returns (uint8[B,
    config.chunk_size] bytes, int32[B] totals) on the device.

    Stored and static lanes decode first; dynamic-tree lanes then decode
    with per-lane code tables, at once where ``config.dynamic_encode``
    says the stream has them.  Raises ValueError("inflate error codes
    [...]") on a lane that fails, DeflateError on dynamic trees that the
    config rejects."""
    padded = np.zeros(len(src) + width, np.uint8)
    padded[: len(src)] = np.frombuffer(src, dtype=np.uint8)
    rows = np.lib.stride_tricks.sliding_window_view(padded, width)[starts]
    with span("td.api.h2d"):
        ends = torch.from_numpy((8 * np.asarray(sizes)).astype(np.int32)).to(device)
        rows = torch.from_numpy(rows).to(device)
    chunk = config.chunk_size

    # stored / static lanes decode without code tables; a stream with
    # dynamic trees decodes again with them where the config allows
    allow_dynamic = config.dynamic and not config.low_lut
    static_first = not config.dynamic_encode or not allow_dynamic
    outs, totals, errs = decode_rows_batch(
        rows, ends, out_cap=chunk, tok_cap=chunk + 16, static_only=static_first,
    )
    with span("td.api.d2h"):
        errs = errs.cpu().numpy()
    if static_first and (errs == ERR_DYNAMIC).any():
        if not allow_dynamic:
            raise DeflateError(
                "dynamic-Huffman block rejected: decoder configured with "
                "dynamic=False/low_lut"
            )
        outs, totals, errs = decode_rows_batch(
            rows, ends, out_cap=chunk, tok_cap=chunk + 16, static_only=False,
        )
        with span("td.api.d2h"):
            errs = errs.cpu().numpy()
    if (errs != 0).any():
        raise ValueError(f"inflate error codes {errs[errs != 0][:8]}")
    return outs, totals


def _encode_lanes(arr: np.ndarray, lengths: np.ndarray, finals: np.ndarray,
                  config: DeflateConfig, device) -> list:
    """Encode the chunks arr uint8[B, C] of lengths int32[B] as lanes on
    ``device``, BFINAL where finals says; the bytes of each lane."""
    out, out_lens, _ = encode_blocks_batch(
        torch.from_numpy(arr).to(device), torch.from_numpy(lengths).to(device),
        torch.from_numpy(finals).to(device), config)
    out, out_lens = out.cpu().numpy(), out_lens.cpu().numpy()
    return [out[i, : out_lens[i]].tobytes() for i in range(len(lengths))]


def compress_gzip(data: bytes, config: DeflateConfig = DeflateConfig(),
                  device="cuda") -> bytes:
    """gzip (RFC 1952) compress on ``device``: one member whose body is
    ``compress``'s DEFLATE body."""
    with span("td.api.compress_gzip"):
        out, out_lens, _ = deflate_device(data, config, device)
        header = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"
        trailer = (zlib.crc32(data).to_bytes(4, "little")
                   + (len(data) & 0xFFFFFFFF).to_bytes(4, "little"))
        return header + _body(out, out_lens) + trailer


# --- self-indexing multi-member gzip ----------------------------------------
#
# Each chunk is a complete gzip member whose FEXTRA subfield 'TD' carries
# the member's total byte length, so member boundaries are found by a hop
# over the headers and the members decode as lanes with no sidecar index,
# while stock gzip reads the stream unchanged (RFC 1952 readers accept
# many members and skip unknown extra fields).

_GZ_SUBFIELD = b"TD"


def _gzip_member_header(member_len: int) -> bytes:
    extra = _GZ_SUBFIELD + (4).to_bytes(2, "little") + member_len.to_bytes(4, "little")
    return (
        b"\x1f\x8b\x08\x04"  # magic, deflate, FLG=FEXTRA
        + b"\x00\x00\x00\x00"  # mtime
        + b"\x00\xff"  # xfl, os
        + len(extra).to_bytes(2, "little")
        + extra
    )


_GZ_HDR_LEN = 10 + 2 + 8  # base + xlen + subfield
# bytes a member's lane reads past its body: a dynamic header's code
# lengths (at most 17 + 57 + 316 * 7 bits) or a symbol that starts before
# the end bit
_READ_ON = 512


def compress_gzip_members(data: bytes, config: DeflateConfig = DeflateConfig(),
                          device="cuda") -> bytes:
    """Multi-member gzip on ``device``: one final member per chunk,
    self-indexing through FEXTRA."""
    arr, lengths = _chunk(data, config.chunk_size)
    bodies = _encode_lanes(arr, lengths, np.ones(len(lengths), dtype=bool),
                           config, device)
    parts = []
    pos = 0
    for n, body in zip(lengths.tolist(), bodies):
        raw = data[pos : pos + n]
        pos += n
        parts.append(_gzip_member_header(_GZ_HDR_LEN + len(body) + 8))
        parts.append(body)
        parts.append(zlib.crc32(raw).to_bytes(4, "little"))
        parts.append((len(raw) & 0xFFFFFFFF).to_bytes(4, "little"))
    return b"".join(parts)


def _scan_gzip_members(data: bytes):
    """Hop over member headers by the 'TD' FEXTRA subfield: a list of
    (body_start, body_end, isize), or None if the stream is not ours."""
    members = []
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos : pos + 2] != b"\x1f\x8b" or len(data) < pos + _GZ_HDR_LEN:
            return None
        if data[pos + 3] != 0x04:
            return None
        xlen = int.from_bytes(data[pos + 10 : pos + 12], "little")
        if xlen != 8 or data[pos + 12 : pos + 14] != _GZ_SUBFIELD:
            return None
        member_len = int.from_bytes(data[pos + 16 : pos + 20], "little")
        body_start = pos + _GZ_HDR_LEN
        body_end = pos + member_len - 8
        isize = int.from_bytes(data[pos + member_len - 4 : pos + member_len], "little")
        if body_end <= body_start or pos + member_len > n:
            return None
        members.append((body_start, body_end, isize))
        pos += member_len
    return members


def decompress_gzip(data: bytes, config: DeflateConfig = DeflateConfig(),
                    device="cuda") -> bytes:
    """gzip decompress on ``device``: self-indexing members as lanes,
    any other gzip member by member.  Raises OverflowError on input of no
    member (the JAX package's type)."""
    members = _scan_gzip_members(data)
    if members is None:
        return _foreign_gzip_device(data, config, device)
    return b"".join(_decode_member_bodies(data, members, config, device))


def _parse_gzip_header(data: bytes, pos: int) -> int:
    """RFC 1952 header walk: the byte offset of the DEFLATE body of the
    member at pos (FEXTRA, FNAME, FCOMMENT and FHCRC skipped)."""
    if data[pos : pos + 2] != b"\x1f\x8b":
        raise DeflateError("bad gzip magic")
    if data[pos + 2] != 8:
        raise DeflateError("unsupported gzip method")
    flg = data[pos + 3]
    p = pos + 10
    if flg & 0x04:  # FEXTRA
        xlen = int.from_bytes(data[p : p + 2], "little")
        p += 2 + xlen
    if flg & 0x08:  # FNAME
        p = data.index(b"\x00", p) + 1
    if flg & 0x10:  # FCOMMENT
        p = data.index(b"\x00", p) + 1
    if flg & 0x02:  # FHCRC
        p += 2
    return p


def _foreign_gzip_device(data: bytes, config: DeflateConfig, device) -> bytes:
    """Gzip that is not self-indexing: members one after another, each
    body inflated on ``device`` from its bit in the whole buffer (member
    boundaries are found only by decoding)."""
    out_all = bytearray()
    pos = 0
    while pos < len(data):
        body_start = _parse_gzip_header(data, pos)
        out, total, end_bit = inflate_device(
            data, start_bit=8 * body_start,
            static_only=config.low_lut or not config.dynamic,
            one_block=config.one_block, device=device,
        )
        p = (end_bit + 7) // 8
        expect_crc = int.from_bytes(data[p : p + 4], "little")
        expect_isize = int.from_bytes(data[p + 4 : p + 8], "little")
        piece = out[:total].tobytes()
        if zlib.crc32(piece) != expect_crc:
            raise DeflateError("gzip CRC-32 mismatch")
        if (total & 0xFFFFFFFF) != expect_isize:
            raise DeflateError("gzip ISIZE mismatch")
        out_all.extend(piece)
        pos = p + 8
    return bytes(out_all)


def _decode_member_bodies(data: bytes, members, config: DeflateConfig, device):
    """Decode self-indexing members of data as lanes on ``device``.
    members: (body_start, body_end, isize) each.  Returns each member's
    bytes, in order, after its ISIZE and CRC-32 checks."""
    chunk = config.chunk_size
    if any(isize > chunk for (_s, _e, isize) in members):
        raise ValueError("member larger than config.chunk_size")
    if not members:  # the JAX package's batch pad overflows here
        raise OverflowError("decompress_gzip: no gzip member")
    starts = np.array([s for s, _e, _n in members], dtype=np.int64)
    sizes = np.array([e for _s, e, _n in members], dtype=np.int64) - starts
    # a lane reads on past its body, as from the JAX package's one buffer
    outs, totals = _decode_lanes(data, starts, sizes, int(sizes.max()) + _READ_ON,
                                 config, device)
    outs, totals = outs.cpu().numpy(), totals.cpu().numpy()
    parts = []
    for i, (_s, e, isize) in enumerate(members):
        piece = outs[i, : totals[i]].tobytes()
        if len(piece) != isize:
            raise ValueError(f"member {i} ISIZE mismatch")
        if zlib.crc32(piece) != int.from_bytes(data[e : e + 4], "little"):
            raise ValueError(f"member {i} CRC-32 mismatch")
        parts.append(piece)
    return parts


class StreamCompressor:
    """Incremental zlib compression on ``device``: feed byte slices with
    compress(); each call encodes the full chunks buffered so far as
    non-final lanes and returns their bytes (the zlib header first).
    flush() encodes the rest, even none, as one final lane and appends
    the Adler-32 trailer."""

    def __init__(self, config: DeflateConfig = DeflateConfig(), device="cuda"):
        self._config = config
        self._device = device
        self._pending = bytearray()
        self._header_sent = False
        self._adler = 1
        self._finished = False

    def compress(self, data: bytes) -> bytes:
        if self._finished:
            raise ValueError("stream already flushed")
        self._pending.extend(data)
        C = self._config.chunk_size
        nfull = len(self._pending) // C
        if nfull == 0:
            return b""
        take = self._pending[: nfull * C]  # a writable copy, for torch
        del self._pending[: nfull * C]
        self._adler = zlib.adler32(take, self._adler)
        body = b"".join(_encode_lanes(
            np.frombuffer(take, np.uint8).reshape(nfull, C),
            np.full(nfull, C, np.int32), np.zeros(nfull, bool), self._config,
            self._device))
        if not self._header_sent:
            self._header_sent = True
            return _ZLIB_HEADER + body
        return body

    def flush(self) -> bytes:
        if self._finished:
            raise ValueError("stream already flushed")
        self._finished = True
        tail = bytes(self._pending)
        self._pending.clear()
        arr, _ = _chunk(tail, self._config.chunk_size)
        self._adler = zlib.adler32(tail, self._adler)
        body = b"".join(_encode_lanes(arr, np.array([len(tail)], np.int32),
                                      np.array([True]), self._config, self._device))
        prefix = b"" if self._header_sent else _ZLIB_HEADER
        self._header_sent = True
        return prefix + body + self._adler.to_bytes(4, "big")


class StreamDecompressor:
    """Incremental decompression on ``device``, the counterpart of
    StreamCompressor: feed compressed slices with decompress(); output
    comes as soon as a unit of it can be decoded.  The first bytes decide
    the mode:

      members  self-indexing gzip: each member once it is all buffered
               (its FEXTRA length says when), decoded as lanes
      zlib     a zlib stream: each block once it is all buffered, stored
               blocks on the host, Huffman blocks by
               ``inflate_stream_step`` with the last 32 KiB of output
               carried across steps
      whole    anything else (gzip that is not self-indexing): all of it
               at flush()

    flush() checks the trailer and returns what is left."""

    def __init__(self, config: DeflateConfig = DeflateConfig(), device="cuda"):
        self._config = config
        self._device = device
        self._buf = bytearray()
        self._finished = False
        self._mode = None  # None (undecided) | "members" | "zlib" | "whole"
        # zlib mode
        self._pending = bytearray()  # compressed bytes after the header
        self._pbit = 0  # bits of _pending[0] already consumed
        self._window = b""  # the last <= 32 KiB of output
        self._adler = 1
        self._zdone = False  # the final block is decoded; the trailer follows

    def _complete_members(self):
        """The complete self-indexing members at the head of the buffer:
        (members, bytes they take), nothing decoded."""
        members = []
        pos = 0
        buf = self._buf
        n = len(buf)
        while pos + _GZ_HDR_LEN <= n:
            if (
                bytes(buf[pos : pos + 2]) != b"\x1f\x8b"
                or buf[pos + 3] != 0x04
                or bytes(buf[pos + 12 : pos + 14]) != _GZ_SUBFIELD
            ):
                raise ValueError("not a self-indexing gzip member stream")
            member_len = int.from_bytes(buf[pos + 16 : pos + 20], "little")
            if pos + member_len > n:
                break  # incomplete member: wait for more input
            body_start = pos + _GZ_HDR_LEN
            body_end = pos + member_len - 8
            isize = int.from_bytes(buf[pos + member_len - 4 : pos + member_len],
                                   "little")
            members.append((body_start, body_end, isize))
            pos += member_len
        return members, pos

    def _emit(self, pieces: list, emitted: bytes) -> None:
        pieces.append(emitted)
        self._adler = zlib.adler32(emitted, self._adler)
        self._window = (bytes(self._window) + emitted)[-32768:]

    def _stored_step(self):
        """The stored block at the head of the pending bytes, decoded on
        the host: (payload, bits consumed, BFINAL), or None where it is
        not all buffered."""
        buf = self._pending
        avail = 8 * len(buf) - self._pbit
        if avail < 3:
            return None
        bfinal = (buf[self._pbit >> 3] >> (self._pbit & 7)) & 1
        lo = (self._pbit + 3 + 7) >> 3  # the byte after the 3-bit header
        if len(buf) < lo + 4:
            return None
        ln = buf[lo] | (buf[lo + 1] << 8)
        nln = buf[lo + 2] | (buf[lo + 3] << 8)
        if ln != (nln ^ 0xFFFF):
            raise ValueError("stored block LEN/NLEN mismatch")
        if len(buf) < lo + 4 + ln:
            return None
        payload = bytes(buf[lo + 4 : lo + 4 + ln])
        return payload, 8 * (lo + 4 + ln) - self._pbit, bool(bfinal)

    def _drain_zlib(self) -> bytes:
        """Decode every block that is all buffered and return its output.
        Stored blocks are byte-aligned in the original stream, which the
        bit-shifted buffer of ``inflate_stream_step`` does not keep, so
        they are copied on the host; a Huffman block is one step on the
        device."""
        static_only = self._config.low_lut or not self._config.dynamic
        pieces = []
        while not self._zdone and self._pending:
            if 8 * len(self._pending) - self._pbit < 3:
                break
            hdr = int.from_bytes(bytes(self._pending[:2]).ljust(2, b"\0"), "little")
            btype = (hdr >> (self._pbit + 1)) & 3
            if btype == 3:
                raise ValueError("invalid DEFLATE block type 3")
            if btype == 0:
                step = self._stored_step()
                if step is None:
                    break
                emitted, consumed, done = step
            else:
                emitted, consumed, done = inflate_stream_step(
                    self._window, bytes(self._pending), self._pbit,
                    static_only=static_only, device=self._device,
                )
                if consumed == 0 and not done:
                    break  # the block is not all buffered yet
            nbit = self._pbit + consumed
            del self._pending[: nbit >> 3]
            self._pbit = nbit & 7
            if emitted:
                self._emit(pieces, emitted)
            self._zdone = done
        return b"".join(pieces)

    def decompress(self, data: bytes) -> bytes:
        if self._finished:
            raise ValueError("stream already finished")
        self._buf.extend(data)
        if self._mode is None and len(self._buf) >= 2:
            if bytes(self._buf[0:2]) == b"\x1f\x8b":
                if len(self._buf) < _GZ_HDR_LEN:
                    return b""  # gzip: the whole base header decides
                is_member = (self._buf[3] == 0x04
                             and bytes(self._buf[12:14]) == _GZ_SUBFIELD)
                self._mode = "members" if is_member else "whole"
            else:
                cmf, flg = self._buf[0], self._buf[1]
                if cmf & 0x0F == 8 and ((cmf << 8) | flg) % 31 == 0:
                    self._mode = "zlib"
                    del self._buf[:2]
                else:
                    self._mode = "whole"
        if self._mode == "zlib":
            self._pending.extend(self._buf)
            self._buf.clear()
            return self._drain_zlib()
        if self._mode != "members":
            return b""  # whole: the output comes at flush
        members, consumed = self._complete_members()
        if not members:
            return b""
        head = bytes(self._buf[:consumed])
        del self._buf[:consumed]
        return b"".join(_decode_member_bodies(head, members, self._config,
                                              self._device))

    def flush(self) -> bytes:
        if self._finished:
            raise ValueError("stream already finished")
        self._finished = True
        if self._mode == "zlib":
            out = self._drain_zlib()
            if not self._zdone:
                raise ValueError("truncated zlib stream at flush")
            trailer_at = (self._pbit + 7) >> 3
            trailer = bytes(self._pending[trailer_at : trailer_at + 4])
            if len(trailer) < 4:
                raise ValueError("truncated zlib trailer at flush")
            if int.from_bytes(trailer, "big") != self._adler:
                raise ValueError("Adler-32 mismatch")
            return out
        tail = bytes(self._buf)
        self._buf.clear()
        if self._mode == "members":
            if tail:
                raise ValueError("truncated gzip member at end of stream")
            return b""
        if not tail:
            return b""
        if tail[:2] == b"\x1f\x8b":
            return decompress_gzip(tail, self._config, self._device)
        return decompress(tail, self._config, self._device)
