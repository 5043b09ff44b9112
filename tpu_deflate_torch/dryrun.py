"""Entry points of a compile check and a multi-device dry run, the port's
counterparts of the JAX package's ``__graft_entry__``.

    python -m tpu_deflate_torch.dryrun            # every visible card
"""

from __future__ import annotations

import gzip
import zlib

import numpy as np
import torch

from tpu_deflate_torch.api import _GZ_HDR_LEN, _gzip_member_header
from tpu_deflate_torch.config import DeflateConfig
from tpu_deflate_torch.ops.encode import encode_block_bits
from tpu_deflate_torch.parallel.shard import decode_sharded, encode_sharded, make_mesh
from tpu_deflate_torch.spec.checksum import crc32


def entry(device="cuda"):
    """(fn, example_args): the single-lane block encoder (match, extend,
    parse, pack) over 4 lanes of 4096 seeded random bytes at window 256
    and max_match 10, the last lane final."""

    def fn(data, lengths, finals):
        outs = [encode_block_bits(data[i], lengths[i], finals[i], window=256,
                                  max_match=10, use_sort_matcher=False)
                for i in range(data.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))

    rng = np.random.default_rng(0)
    B, C = 4, 4096
    data = torch.as_tensor(rng.integers(0, 256, (B, C), dtype=np.uint8), device=device)
    lengths = torch.full((B,), C, dtype=torch.int32, device=device)
    finals = torch.zeros(B, dtype=torch.bool, device=device)
    finals[B - 1] = True
    return fn, (data, lengths, finals)


def _corpus(nbytes: int) -> bytes:
    """Compressible-but-nontrivial text: repeated phrases + counters."""
    parts = []
    i = 0
    while sum(map(len, parts)) < nbytes:
        parts.append(b"tpu deflate dryrun %d! " % (i * 7919 % 1000))
        i += 1
    return b"".join(parts)[: nbytes - 37]


def _pack_chunks(text: bytes, chunk: int, B: int):
    raw = np.frombuffer(text, np.uint8)
    data = np.zeros((B, chunk), np.uint8)
    lens = np.zeros((B,), np.int32)
    for i in range(B):
        part = raw[i * chunk : (i + 1) * chunk]
        data[i, : len(part)] = part
        lens[i] = len(part)
    return data, lens


def _padded(stream: bytes) -> np.ndarray:
    """The stream zero-padded to a power of two, as the decoder reads it."""
    buf = np.zeros(1 << int(np.ceil(np.log2(max(len(stream), 2)))), np.uint8)
    buf[: len(stream)] = np.frombuffer(stream, np.uint8)
    return buf


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the sharded pipeline once over a mesh of n_devices devices: the
    first n_devices cards, or the CPU listed n_devices times.

    Three containers, each a round trip checked by stock zlib or gzip:

      1. win256/m10 static zlib stream, 32 KiB chunks: sharded encode, the
         Adler fold across the mesh, sharded chunk-parallel decode;
      2. the same with dynamic-Huffman encode, decoded by the dynamic
         decoder;
      3. the self-indexing gzip-member container: every chunk a complete
         member (sharded encode with every lane final), assembled on the
         host, read by stock gzip, then the member bodies decoded
         chunk-parallel.
    """
    kind = torch.device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count()
        assert have >= n_devices, f"need {n_devices} devices, have {have}"
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [torch.device(device)] * n_devices
    mesh = make_mesh(devices)

    chunk = 1 << 15
    per_dev = 2
    B = n_devices * per_dev
    text = _corpus(B * chunk)
    data, lens = _pack_chunks(text, chunk, B)
    finals = np.zeros((B,), bool)
    finals[-1] = True

    def roundtrip_zlib(cfg: DeflateConfig, static_only: bool, name: str):
        out, sizes, adler = encode_sharded(data, lens, finals, mesh, cfg)
        out_h = out.cpu().numpy()
        sizes_h = sizes.cpu().numpy()
        body = b"".join(out_h[i, : sizes_h[i]].tobytes() for i in range(B))
        stream = b"\x78\x9c" + body + int(adler).to_bytes(4, "big")
        assert zlib.decompress(stream) == text, f"{name}: encode round-trip"

        offsets = np.concatenate([[0], np.cumsum(sizes_h)]).astype(np.int64)
        outs, totals, errs = decode_sharded(
            _padded(body), (8 * offsets[:-1]).astype(np.int32),
            (8 * offsets[1:]).astype(np.int32), mesh, chunk_out_size=chunk,
            static_only=static_only)
        outs, totals = outs.cpu().numpy(), totals.cpu().numpy()
        assert (errs.cpu().numpy() == 0).all(), f"{name}: decode errors"
        got = b"".join(outs[i, : totals[i]].tobytes() for i in range(B))
        assert got == text, f"{name}: sharded decode mismatch"
        print(f"dryrun config ok: {name}: {len(text)} -> {len(body)} bytes, "
              f"round-trip verified on the {n_devices}-device mesh")

    roundtrip_zlib(DeflateConfig(window=256, max_match=10, chunk_size=chunk),
                   static_only=True, name="static win256/m10")
    roundtrip_zlib(DeflateConfig(window=256, max_match=10, chunk_size=chunk,
                                 dynamic_encode=True),
                   static_only=False, name="dynamic win256/m10")

    gz_cfg = DeflateConfig(window=256, max_match=10, chunk_size=chunk)
    out, sizes, _ = encode_sharded(data, lens, np.ones(B, bool), mesh, gz_cfg)
    out_h, sizes_h = out.cpu().numpy(), sizes.cpu().numpy()
    parts, starts, ends = [], [], []
    pos = off = 0
    for i in range(B):
        raw = text[pos : pos + int(lens[i])]
        pos += int(lens[i])
        bodyb = out_h[i, : sizes_h[i]].tobytes()
        member_len = _GZ_HDR_LEN + len(bodyb) + 8
        hdr = _gzip_member_header(member_len)
        parts += [hdr, bodyb, crc32(raw).to_bytes(4, "little"),
                  (len(raw) & 0xFFFFFFFF).to_bytes(4, "little")]
        starts.append(off + len(hdr))
        ends.append(off + len(hdr) + len(bodyb))
        off += member_len
    gz_stream = b"".join(parts)
    assert gzip.decompress(gz_stream) == text, "gzip-member container invalid"
    # each member body is a whole raw DEFLATE stream from its first byte
    outs, totals, errs = decode_sharded(
        _padded(gz_stream), 8 * np.asarray(starts, np.int32),
        8 * np.asarray(ends, np.int32), mesh, chunk_out_size=chunk,
        static_only=True)
    outs, totals = outs.cpu().numpy(), totals.cpu().numpy()
    assert (errs.cpu().numpy() == 0).all(), "gzip-member decode errors"
    got = b"".join(outs[i, : totals[i]].tobytes() for i in range(B))
    assert got == text, "gzip-member sharded decode mismatch"
    print(f"dryrun config ok: gzip-member container: {len(text)} -> "
          f"{len(gz_stream)} bytes, verified by stock gzip + mesh decode")
    print(f"dryrun_multichip ok: {n_devices} devices, {B} chunks x {chunk} B, "
          f"3 configs (static, dynamic, gzip-member) round-trip verified")


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", [tuple(o.shape) for o in fn(*args)])
    dryrun_multichip(torch.cuda.device_count())
