"""Block encoder for chunk lanes, static Huffman trees, window <= 256.

Four stages per lane, all lanes at once:

  1+2. match search and extension — the ``match2`` kernel;
  3.   greedy parse: the token starts are the positions reachable from 0
       under next[i] = i + max(length[i], 1) (``ops.decode.chase_reach``);
  4.   emissions: each token's static code plus extra bits as one value
       and bit width, bit offsets by prefix sum, then the bytes by a
       scatter-add of 16-bit channels (the ``monotone`` kernel).

Each lane is one static block; a non-final lane ends byte-aligned with an
empty stored block, so lanes concatenate bytewise into one stream, and a
lane whose stored encoding is shorter is emitted stored instead.  Output
is byte-identical to ``tpu_deflate.ops.encode.encode_blocks_batch``.
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.config import DeflateConfig
from tpu_deflate_torch.kernels.match2 import MAX_WINDOW, match_bitplane_batch
from tpu_deflate_torch.kernels.monotone import mono_scatter_add
from tpu_deflate_torch.ops.decode import chase_reach
from tpu_deflate_torch.spec import tables as T

_STORED_MAX = 65535


def max_output_bytes(n: int) -> int:
    """Bound on one block's compressed size: 9 bits per literal, header,
    end-of-block and the stored-block alignment tail, plus slack."""
    return n + (n >> 3) + 64


def _table(name: str, device) -> torch.Tensor:
    return torch.as_tensor(getattr(T, name), dtype=torch.int64, device=device)


def _greedy_parse(length: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Token-start mask bool[B, N] of the greedy parse."""
    N = length.shape[1]
    step = torch.where(length >= 3, length, 1)
    reach = chase_reach(step, torch.zeros_like(step, dtype=torch.bool))
    return reach & (torch.arange(N, device=length.device) < n[:, None])


def _encode_emissions(data, n, final, dist, length):
    """Stages 3-4 up to the bit offsets: (vals, nbs, offs int64[B, N + 2],
    total_bits int64[B], ntok int32[B]).  Entry 0 is the 3-bit block
    header, entries 1..N the token at each position (width 0 where none
    starts), entry N + 1 the end-of-block code."""
    B, N = data.shape
    dev = data.device
    start = _greedy_parse(length, n)
    ln = length.to(torch.int64).clamp(0, 258)
    is_match = start & (ln >= 3)
    is_lit = start & ~is_match

    lsym = _table("LEN_TO_SYM", dev)[ln]
    litlen_sym = torch.where(is_lit, data.to(torch.int64), 257 + lsym)
    code = _table("STATIC_LITLEN_CODES_REV", dev)[litlen_sym]
    clen = _table("STATIC_LITLEN_LENGTHS", dev)[litlen_sym]
    lextra = torch.where(is_match, _table("LEN_TO_EXTRA", dev)[ln], 0)
    lebits = torch.where(is_match, _table("LENGTH_EXTRA_BITS", dev)[lsym], 0)
    e0_val = code | (lextra << clen)
    e0_nb = torch.where(start, clen + lebits, 0)

    d = dist.to(torch.int64).clamp(0, 32768)
    dsym = _table("DIST_TO_SYM", dev)[d]
    dcode = torch.where(is_match, _table("STATIC_DIST_CODES_REV", dev)[dsym], 0)
    dextra = torch.where(is_match, _table("DIST_TO_EXTRA", dev)[d], 0)
    debits = torch.where(is_match, _table("DIST_EXTRA_BITS", dev)[dsym], 0)
    e12_val = dcode | (dextra << 5)  # 5-bit distance code, then its extras
    e12_nb = torch.where(is_match, 5 + debits, 0)

    # one value per position: literal/length code and extras (<= 13 bits),
    # then distance code and extras (<= 18 bits)
    vals = e0_val | (e12_val << e0_nb)
    nbs = e0_nb + e12_nb
    hdr = final.to(torch.int64) | (1 << 1)  # BFINAL, BTYPE=01 (static)
    zero = torch.zeros(B, 1, dtype=torch.int64, device=dev)
    vals = torch.cat([hdr[:, None], vals, zero], dim=1)  # EOB code is 0
    nbs = torch.cat([zero + 3, nbs, zero + 7], dim=1)
    csum = torch.cumsum(nbs, dim=1)
    offs = csum - nbs
    ntok = start.sum(1).to(torch.int32)
    return vals, nbs, offs, csum[:, -1], ntok


def _bitpack_entries(vals, nbs, offs, max_match: int):
    """Scatter-add entries of the bit-pack: (byte index int32[B, K],
    16-bit channels int32[B, C, K]).

    A value of emax bits shifted by its bit offset (<= 7) spans
    ceil((emax + 7) / 16) channels, added at bytes j, j+2, j+4.  With
    window <= 256 and max_match <= 18 every value fits 20 bits: 2 channels."""
    emax = 20 if max_match <= 18 else 31
    s = offs & 7
    v = torch.where(nbs > 0, vals, 0) << s  # < 2^38
    ch = torch.stack(
        [(v >> (16 * c)) & 0xFFFF for c in range(-(-(emax + 7) // 16))], dim=1
    )
    return (offs >> 3).to(torch.int32), ch.to(torch.int32)


def _stored_output(data, n, final, M: int):
    """Stored-block encoding of each lane's data[:n]: ceil(n / 65535)
    blocks of a 5-byte header and raw bytes.  Returns (int32[B, M],
    out_len int64[B])."""
    B, N = data.shape
    dev = data.device
    nblocks = max(1, -(-N // _STORED_MAX))
    M_big = max(M, nblocks * (_STORED_MAX + 5) + 8)
    out = torch.zeros(B, M_big, dtype=torch.int32, device=dev)
    n = n.to(torch.int64)
    nb_live = ((n + _STORED_MAX - 1) // _STORED_MAX).clamp_min(1)
    for sb in range(nblocks):
        o = sb * (_STORED_MAX + 5)
        live = (n > sb * _STORED_MAX) | (sb == 0)
        sb_len = (n - sb * _STORED_MAX).clamp(0, _STORED_MAX)
        hdr = (final & (sb + 1 >= nb_live)).to(torch.int64)
        nlen = sb_len ^ 0xFFFF
        head = torch.stack(
            [hdr, sb_len & 0xFF, sb_len >> 8, nlen & 0xFF, nlen >> 8], dim=1
        )
        out[:, o : o + 5] = torch.where(live[:, None], head, 0)
        seg = data[:, sb * _STORED_MAX : (sb + 1) * _STORED_MAX].to(torch.int32)
        j = torch.arange(seg.shape[1], device=dev)
        keep = live[:, None] & (j < sb_len[:, None])
        out[:, o + 5 : o + 5 + seg.shape[1]] = torch.where(keep, seg, 0)
    return out[:, :M], nb_live * 5 + n


def _finalize_block(data, n, final, out, total_bits, M: int):
    """Byte alignment and the stored fallback, out int32[B, M] -> (uint8
    bytes, int32 lengths).  A final block pads to a byte with zero bits; a
    non-final one appends an empty stored block (3-bit header 000, align,
    LEN=0, NLEN=FFFF) so lanes concatenate bytewise."""
    final_len = (total_bits + 7) >> 3
    aligned = (total_bits + 3 + 7) >> 3
    ff = torch.where(final, 0, 0xFF).to(torch.int32)[:, None]
    for k in (2, 3):
        at = (aligned + k).clamp(0, M - 1)[:, None]
        out = out.scatter_add(1, at, ff)
    out_len = torch.where(final, final_len, aligned + 4)
    out_s, out_len_s = _stored_output(data, n, final, M)
    use_stored = out_len_s < out_len
    out = torch.where(use_stored[:, None], out_s, out)
    out_len = torch.where(use_stored, out_len_s, out_len)
    return out.to(torch.uint8), out_len.to(torch.int32)


def encode_blocks_batch(data: torch.Tensor, lengths: torch.Tensor,
                        finals: torch.Tensor, config: DeflateConfig = DeflateConfig()):
    """Encode lanes data uint8[B, N] of lengths int32[B]; finals bool[B]
    sets BFINAL.  Returns (out uint8[B, M], out_lens int32[B], ntok
    int32[B]) with M = max_output_bytes(N)."""
    if config.window > MAX_WINDOW or config.dynamic_encode or config.lazy:
        raise NotImplementedError(
            "the port encodes static trees, window <= 256, greedy parse only"
        )
    B, N = data.shape
    M = max_output_bytes(N)
    lengths = lengths.to(torch.int32)
    dist, length = match_bitplane_batch(
        data, lengths, config.window, config.max_match
    )
    vals, nbs, offs, total_bits, ntok = _encode_emissions(
        data, lengths, finals, dist, length
    )

    idx, ch = _bitpack_entries(vals, nbs, offs, config.max_match)
    packed = mono_scatter_add(idx, ch, M + 8)
    # emissions are bit-disjoint, so every byte sum below is carry-free
    out = torch.zeros(B, M, dtype=torch.int32, device=data.device)
    for c in range(ch.shape[1]):
        disp = 2 * c
        out[:, disp:] += packed[:, c, : M - disp] & 0xFF
        out[:, disp + 1 :] += (packed[:, c, : M - disp - 1] >> 8) & 0xFF
    return _finalize_block(data, lengths, finals, out, total_bits, M) + (ntok,)
