"""Public compress / decompress API over the device encoder and decoder.

The input is split into fixed-size chunks; every chunk is encoded on the
device as an independent byte-aligned DEFLATE block run, and the chunks
concatenate bytewise into one RFC 1950 stream whose Adler-32 is folded
from per-chunk states.  The indexed form also returns each chunk's
compressed size, which lets ``decompress_indexed`` decode every chunk as
its own lane.  Streams are byte-identical to the JAX package's.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from tpu_deflate_torch.config import DeflateConfig
from tpu_deflate_torch.ops.checksum import adler32_fold, adler32_state
from tpu_deflate_torch.ops.decode import (
    ERR_DYNAMIC,
    decode_rows_batch,
    zlib_decompress_device,
)
from tpu_deflate_torch.ops.encode import encode_blocks_batch
from tpu_deflate_torch.ref.inflate import DeflateError

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
    chunks = torch.from_numpy(arr).to(device)
    lens = torch.from_numpy(lengths).to(device)
    finals = torch.zeros(len(lengths), dtype=torch.bool, device=device)
    finals[-1] = True
    out, out_lens, _ = encode_blocks_batch(chunks, lens, finals, config)
    a, b = adler32_state(chunks, lens)
    return out, out_lens, adler32_fold(a, b, lens)


def _stream(out: torch.Tensor, out_lens: torch.Tensor, adler: int) -> bytes:
    keep = torch.arange(out.shape[1], device=out.device) < out_lens[:, None]
    body = out[keep].cpu().numpy().tobytes()  # row-major: chunks in order
    return _ZLIB_HEADER + body + adler.to_bytes(4, "big")


def compress(data: bytes, config: DeflateConfig = DeflateConfig(),
             device="cuda") -> bytes:
    """zlib-compatible compress on ``device``."""
    if not config.compress:
        raise ValueError("config disables compress")
    return _stream(*deflate_device(data, config, device))


def decompress(data: bytes, config: DeflateConfig = DeflateConfig(),
               device="cuda") -> bytes:
    """zlib-compatible decompress on ``device`` of any zlib stream, as one
    lane; raises DeflateError on a corrupt stream."""
    if not config.decompress:
        raise ValueError("config disables decompress")
    return zlib_decompress_device(data, config, device)


def compress_indexed(data: bytes, config: DeflateConfig = DeflateConfig(),
                     device="cuda"):
    """Compress and return (zlib stream, int64 compressed size of each
    chunk).  The index is a sidecar: any zlib reads the stream alone."""
    out, out_lens, adler = deflate_device(data, config, device)
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
    byte, and a lane whose end comes before its start is empty.  Stored
    and static lanes decode first; dynamic-tree lanes then decode with
    per-lane code tables, at once where ``config.dynamic_encode`` says the
    stream has them.  Raises ValueError on a corrupt stream or an index
    that does not cover it, OverflowError on an index of no chunk (the
    JAX package's type), DeflateError on dynamic trees that the config
    rejects."""
    body = stream[2:-4]
    index = np.asarray(index, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(index)])
    if offsets[-1] != len(body):
        raise ValueError("index does not cover the stream body")
    if len(index) == 0:  # the JAX package's batch pad overflows here
        raise OverflowError("decompress_indexed: the index has no chunk")
    width = max(int(index.max(initial=0)), 1)
    padded = np.zeros(len(body) + width, np.uint8)
    padded[: len(body)] = np.frombuffer(body, dtype=np.uint8)
    starts = np.clip(offsets[:-1], 0, len(body))
    rows = np.lib.stride_tricks.sliding_window_view(padded, width)[starts]
    ends = torch.from_numpy((8 * index).astype(np.int32)).to(device)
    rows = torch.from_numpy(rows).to(device)
    chunk = config.chunk_size

    # stored / static lanes decode without code tables; a stream with
    # dynamic trees decodes again with them where the config allows
    allow_dynamic = config.dynamic and not config.low_lut
    static_first = not config.dynamic_encode or not allow_dynamic
    outs, totals, errs = decode_rows_batch(
        rows, ends, out_cap=chunk, tok_cap=chunk + 16, static_only=static_first,
    )
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
        errs = errs.cpu().numpy()
    if (errs != 0).any():
        raise ValueError(f"inflate error codes {errs[errs != 0][:8]}")
    keep = torch.arange(chunk, device=outs.device) < totals[:, None]
    result = outs[keep].cpu().numpy().tobytes()
    if zlib.adler32(result) != int.from_bytes(stream[-4:], "big"):
        raise ValueError("Adler-32 mismatch")
    return result
