"""The device-paced decode of one stream, and the segmented expansion of
a long stream's tokens.

``inflate_foreign_device`` is the counterpart of ``tpu_deflate.ops.
foreign``: it walks any DEFLATE stream one block per step.  A stored block
is bookkeeping on the host; a Huffman block's header is parsed on the
device (a dynamic header's code lengths through ``visited_from_adv``, as
``cl_reach``) and its symbols decoded by the tile-parallel
``tokenize_dyn_hier`` over a window of PW bits re-based at the byte of its
first symbol.  The tokens accumulate in one buffer on the device, and the
expansion runs once at the end.  The loop runs on the host, with one
device-to-host read of each Huffman block's scalars; block types and a
stored block's LEN/NLEN come from a host copy of the stream.  A stream
that the tokenizer cannot serve (a literal/length code under 2 bits, a
block longer than the window or than one token slab) reports FALLBACK,
and the caller decodes it with the general pipeline (``ops.decode.
_inflate_general``).

``expand_segments``: tokens are ordered with known output offsets and
back-references reach at most 32 KiB, so a stream of any length expands
in segments of whole tokens of about SEG output bytes: segment k holds
the tokens whose offsets lie in [k * SEG, (k + 1) * SEG), so its output
starts at a ragged base within 258 bytes (65535 after a stored block) of
k * SEG, and a token that crosses a boundary belongs to the segment where
it starts.  Each segment expands through ``ops.expand.expand_batch`` with
the previous 32 KiB of output prepended as literal tokens, at one fixed
row length (a multiple of 2048 under 2^20): a segment without stored
tokens launches ``expand_fused2`` with distances up to 32768, one with a
stored token ``resolve_roots``.  The counterpart of ``tpu_deflate.ops.
foreign._expand_segments``, with a host loop over the segments.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_deflate_torch.kernels.chase1 import visited_from_adv
from tpu_deflate_torch.kernels.tokenize import (
    ERR_BAD_CODE,
    ERR_INPUT,
    ERR_METHOD,
    ERR_NAMES,
    ERR_OVERFLOW,
    ERR_STORED,
    TK_LIT,
    TK_STORED,
)
from tpu_deflate_torch.kernels.tokenize_dyn import (
    MIN_LIT_LEN_FOREIGN,
    tokenize_dyn_hier,
)
from tpu_deflate_torch.ops.expand import OTILE, expand, expand_batch, pow2_at_least
from tpu_deflate_torch.ops.header import (
    MAX_SYMS,
    canon_params,
    decode_cl_lengths,
    pack_block_tab,
)
from tpu_deflate_torch.ref.inflate import DeflateError
from tpu_deflate_torch.spec import tables as T

SEG = 1 << 19  # output bytes per expansion segment
WIN = 1 << 15  # RFC window carried between segments
# a segment's row: the window, SEG bytes, and the longest emission past
# the boundary (a stored token's 65535 bytes; a match's only 258)
SLAB = SEG + 65536 + 512
SEG_CAP = -(-(WIN + SLAB) // OTILE) * OTILE


def expand_segments(data: torch.Tensor, tk: torch.Tensor, ta: torch.Tensor,
                    tb: torch.Tensor, out_total: int) -> torch.Tensor:
    """data uint8[M] (stored tokens copy from it), tk, ta, tb int32[K] live
    tokens producing out_total bytes -> uint8[out_total]."""
    dev = tk.device
    n = torch.where(tk == TK_LIT, 1, ta).to(torch.int64)
    off = torch.cumsum(n, 0) - n
    nseg = -(-out_total // SEG)
    edges = torch.searchsorted(
        off, SEG * torch.arange(nseg + 1, device=dev), right=False)
    lo = edges.tolist()
    bases = torch.cat([off, off.new_tensor([out_total])])[edges].tolist()
    out = torch.zeros(out_total, dtype=torch.uint8, device=dev)
    zeros = torch.zeros(WIN, dtype=torch.int32, device=dev)
    window = zeros
    rows = data[None]
    for k in range(nseg):
        base, nxt = bases[k], bases[k + 1]
        sl = slice(lo[k], lo[k + 1])
        if k:  # the output just before this segment, as literal tokens
            window = out[base - WIN : base].to(torch.int32)
        tk2 = torch.cat([zeros, tk[sl]])[None]
        ta2 = torch.cat([window, ta[sl]])[None]
        tb2 = torch.cat([zeros, tb[sl]])[None]
        tp2 = torch.tensor([tk2.shape[1]], dtype=torch.int32, device=dev)
        seg, _ = expand_batch(rows, tk2, ta2, tb2, tp2, SEG_CAP)
        out[base:nxt] = seg[0, WIN : WIN + nxt - base]
    return out


PW = 1 << 19  # bit window per block: zlib ends a block after 16384 symbols
WINB = PW // 8 + 16  # window bytes
CLW = 8192  # bits searched for a dynamic header's code lengths (T = 128)

# loop modes
RUNNING = 0
DONE = 1
FAILED = 2
FALLBACK = 3


def cl_reach(adv: torch.Tensor, term: torch.Tensor) -> torch.Tensor:
    """``decode_cl_lengths``' reach_fn at win = CLW for one lane: adv,
    term [1, CLW] -> the positions reachable from 0, bool[1, CLW], by
    ``visited_from_adv`` in its (in-tile position, tile) layout."""
    Tt = CLW // 64
    advT = adv.reshape(Tt, 64).T.to(torch.int32).contiguous()
    termT = term.reshape(Tt, 64).T.to(torch.int32).contiguous()
    p0 = torch.zeros((), dtype=torch.int32, device=adv.device)
    return visited_from_adv(advT, termT, p0).T.reshape(1, -1) != 0


def _peek(host: np.ndarray, pos: int, nbits: int) -> int:
    """nbits (<= 24) bits at bit pos of the padded stream."""
    i = min(pos >> 3, len(host) - 4)
    return (int.from_bytes(host[i : i + 4].tobytes(), "little")
            >> (pos & 7)) & ((1 << nbits) - 1)


def _huffman_block(arr, host, pos: int, out_total: int, end_bit: int):
    """Parse the Huffman block header at bit pos (static or dynamic), then
    tokenize its symbols in a PW-bit window from the byte of the first
    symbol.  Returns the tokenizer's (tk, ta, tb, ...) and the host
    scalars (hdr_ok, min_len, kerr, ntok, outp, endp, base2, small) of
    the one device-to-host read."""
    dev = arr.device
    i64 = torch.int64
    if _peek(host, pos + 1, 2) == 1:
        lit = torch.as_tensor(T.STATIC_LITLEN_LENGTHS, dtype=i64, device=dev)[None]
        dist = torch.as_tensor(T.STATIC_DIST_LENGTHS, dtype=i64, device=dev)[None]
        start = torch.tensor([pos + 3], dtype=i64, device=dev)
        hdr_ok = torch.ones(1, dtype=torch.bool, device=dev)
    else:
        hlit = _peek(host, pos + 3, 5) + 257
        hdist = _peek(host, pos + 8, 5) + 1
        hclen = _peek(host, pos + 13, 4) + 4
        cl = np.zeros(19, np.int64)
        for j in range(hclen):
            cl[T.CODE_LENGTH_ORDER[j]] = _peek(host, pos + 17 + 3 * j, 3)
        clim, crd, csym, cover = canon_params(torch.from_numpy(cl).to(dev)[None], 19)
        cl_pos = pos + 17 + 3 * hclen
        at = cl_pos >> 3  # the code lengths' bits, from a byte boundary
        lengths, end_next, cl_ok = decode_cl_lengths(
            arr[None, at : at + CLW // 8 + 16].to(i64),
            torch.tensor([cl_pos & 7], dtype=i64, device=dev),
            torch.tensor([hlit + hdist], dtype=i64, device=dev), clim, crd, csym,
            win=CLW, reach_fn=cl_reach)
        sidx = torch.arange(MAX_SYMS, device=dev)
        lit = torch.where(sidx < hlit, lengths, 0)[:, :288]
        d = torch.arange(32, device=dev)
        dist = torch.where(d < hdist, lengths[:, (hlit + d).clamp(0, MAX_SYMS - 1)], 0)
        start = cl_pos + end_next
        hdr_ok = cl_ok & ~cover
    tab, min_len, trees_ok = pack_block_tab(
        lit, dist, start & 7, torch.tensor([out_total], dtype=i64, device=dev))
    hdr_ok = hdr_ok & trees_ok
    base2 = start >> 3
    # the window's first byte stays inside the padded stream, as a JAX
    # dynamic_slice clamps it
    first = base2.clamp(0, arr.shape[0] - WINB)
    win = arr[first + torch.arange(WINB, device=dev)]
    end_rel = end_bit - 8 * base2
    res = tokenize_dyn_hier(win[None], end_rel.clamp(max=PW).to(torch.int32),
                            tab.to(torch.int32), (start & 7).to(torch.int32), PW)
    scal = torch.cat([hdr_ok.to(i64), min_len.to(i64),
                      *(r.to(i64) for r in res[3:]), base2, (end_rel <= PW - 64).to(i64)])
    hdr_ok, min_len, ntok, outp, endp, kerr, base2, small = scal.tolist()
    return res[:3], (bool(hdr_ok), min_len, kerr, ntok, outp, endp, base2, bool(small))


def _foreign_loop(arr: torch.Tensor, host: np.ndarray, start_bit: int,
                  end_bit: int, tok_cap: int):
    """Walk the blocks of the stream from start_bit: (mode, err, tk, ta,
    tb int32[tok_cap], tp, out_total, pos)."""
    dev = arr.device
    tk, ta, tb = (torch.zeros(tok_cap, dtype=torch.int32, device=dev)
                  for _ in range(3))
    stored = []  # (slot, LEN, byte offset) of each stored block's token
    pos, mode, tp, total, err, it = start_bit, RUNNING, 0, 0, 0, 0
    max_it = max((end_bit - start_bit) // 32 + 8, 8)
    while (mode == RUNNING and pos < end_bit and it < max_it
           and tp < tok_cap - (PW // 8 + 8192)):
        bfinal, btype = _peek(host, pos, 1), _peek(host, pos + 1, 2)
        if btype == 0:
            p = (pos + 3 + 7) & ~7
            ln, nln = _peek(host, p, 16), _peek(host, p + 16, 16)
            ok = ln == nln ^ 0xFFFF
            stored.append((tp, ln, (p + 32) >> 3))
            tp, total, pos = tp + 1, total + ln, p + 32 + 8 * ln
            mode = FAILED if not ok else DONE if bfinal else RUNNING
            err = err if ok else ERR_STORED
        elif btype == 3:
            mode, err = FAILED, ERR_METHOD
        else:
            toks, (hdr_ok, min_len, kerr, ntok, outp, endp, base2, small) = \
                _huffman_block(arr, host, pos, total, end_bit)
            fallback = (min_len < MIN_LIT_LEN_FOREIGN
                        or (kerr == ERR_INPUT and not small)
                        or kerr == ERR_OVERFLOW)
            ok = hdr_ok and kerr == 0 and not fallback
            if ok:
                for buf, t in zip((tk, ta, tb), toks):
                    buf[tp : tp + ntok] = t[0, :ntok]
                pos, tp, total = 8 * base2 + endp, tp + ntok, total + outp
            mode = (FALLBACK if fallback else
                    (DONE if bfinal else RUNNING) if ok else FAILED)
            if not (ok or fallback):
                err = ERR_BAD_CODE if not hdr_ok else kerr
        it += 1
    if stored:
        slot, ln, off = torch.tensor(stored, dtype=torch.int64).T.to(dev)
        tk[slot], ta[slot], tb[slot] = TK_STORED, ln.to(torch.int32), off.to(torch.int32)
    # running out of input without BFINAL is a truncated stream
    if mode == RUNNING:
        mode, err = FAILED, err or ERR_INPUT
    return mode, err, tk, ta, tb, tp, total, pos


def inflate_foreign_device(data, start_bit: int = 0, device="cuda"):
    """Device-paced inflate of a raw DEFLATE stream (bytes or a uint8
    array) from start_bit on: (uint8 numpy array, output length, end bit)
    as ``ops.decode.inflate_device`` returns them, or None where the
    stream needs the general pipeline (FALLBACK).  Raises DeflateError on
    a corrupt stream."""
    raw = np.frombuffer(bytes(data), dtype=np.uint8)
    m = len(raw)
    m_pad = max(1 << 12, pow2_at_least(m))
    host = np.pad(raw, (0, m_pad - m + WINB + 1200))
    arr = torch.from_numpy(host).to(device)
    # the JAX package's capacity: a token per 3 bits of the padded input
    # and two token slabs of slack for the loop's guard
    tok_cap = (8 * m_pad) // 3 + 2 * (PW // 8 + 8192) + 16384
    tok_cap = -(-tok_cap // 1024) * 1024
    mode, err, tk, ta, tb, tp, total, pos = _foreign_loop(
        arr, host, start_bit, 8 * m, tok_cap)
    if mode == FALLBACK:
        return None
    if mode != DONE:
        raise DeflateError(
            f"corrupt stream: {ERR_NAMES.get(err, f'error code {err}')}")
    return expand_stream(arr, tk, ta, tb, tp, total).cpu().numpy(), total, pos


def expand_stream(arr: torch.Tensor, tk: torch.Tensor, ta: torch.Tensor,
                  tb: torch.Tensor, tp: int, total: int) -> torch.Tensor:
    """A whole stream's tokens (the first tp of tk, ta, tb int32[K]) ->
    uint8 bytes, at least total of them: one row of a power of two up to
    SEG + 256 bytes, else segments (``expand_segments``)."""
    if total > SEG + 256:
        return expand_segments(arr, tk[:tp], ta[:tp], tb[:tp], total)
    live = max(tp, 1)  # the expanders index a row of at least one slot
    out, _ = expand(arr, tk[:live], ta[:live], tb[:live], tp,
                    max(1 << 12, pow2_at_least(total)))
    return out
