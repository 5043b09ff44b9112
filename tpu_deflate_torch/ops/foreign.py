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
stored block's LEN/NLEN come from a host copy of the stream, and the
header values read there go up to the card without a wait.  On a card a
dynamic header's parse, some 300 small operations, is one CUDA graph
captured once and replayed a block (``_HeaderGraph``).  A block with a
literal/length code under 2 bits, which the tile-parallel tokenizer
cannot serve, is tokenized again by the general pipeline's lane
tokenizer (``tokenize_dyn_batch``, one lane walking its symbols in turn)
under the same tables, and the walk goes on after it.  A stream with a
block longer than the window or than one token slab reports FALLBACK,
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
from tpu_deflate_torch.kernels.monotone import mono_compact
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
    tokenize_dyn_batch,
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
from tpu_deflate_torch.utils.profiling import count, span, tally

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
    count("segments", nseg)
    edges = torch.searchsorted(
        off, SEG * torch.arange(nseg + 1, device=dev), right=False)
    with tally("d2h"):
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
        tp2 = _upload([tk2.shape[1]], dev, torch.int32)
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


_STATIC_LENGTHS = np.array([*T.STATIC_LITLEN_LENGTHS, *T.STATIC_DIST_LENGTHS], np.int64)


def _upload(values, dev, dtype=torch.int64) -> torch.Tensor:
    """Host values onto dev without a wait for the stream: on a card from
    pinned memory, which the copy keeps until it has run."""
    t = torch.as_tensor(values, dtype=dtype)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def _dynamic_header(up: torch.Tensor, clw: torch.Tensor):
    """A dynamic block's header from values on the device alone, so that
    one CUDA graph can replay it (``_HeaderGraph``): up int64[25] holds
    the code-length code's 19 lengths, the code lengths' first bit within
    their byte, HLIT + HDIST, the output bytes before the block, HLIT,
    HDIST and the code lengths' bit position; clw uint8[1, CLW / 8 + 16]
    is the stream from the code lengths' byte on.  Returns (tab int64[1,
    TAB_W], min_len, hdr_ok, start int64[1], the bit of the first
    symbol)."""
    dev = up.device
    clim, crd, csym, cover = canon_params(up[None, :19], 19)
    lengths, end_next, cl_ok = decode_cl_lengths(
        clw.to(torch.int64), up[19:20], up[20:21], clim, crd, csym, win=CLW,
        reach_fn=cl_reach)
    hlit, hdist = up[22:23], up[23:24]
    lit = torch.where(torch.arange(MAX_SYMS, device=dev) < hlit, lengths, 0)[:, :288]
    d = torch.arange(32, device=dev)
    dist = torch.where(d < hdist, lengths[:, (hlit + d).clamp(0, MAX_SYMS - 1)], 0)
    start = up[24:25] + end_next
    tab, min_len, trees_ok = pack_block_tab(lit, dist, start & 7, up[21:22])
    return tab, min_len, cl_ok & ~cover & trees_ok, start


class _HeaderGraph:
    """``_dynamic_header`` captured once on a card as one CUDA graph and
    replayed a block: one launch from the host in place of some 300.  It
    reads its values from, and returns them at, fixed addresses; each
    replay launches ``visited_from_adv`` and ``mono_compact`` once, and
    counts them as their launchers do."""

    def __init__(self, dev: torch.device):
        self.up = torch.zeros(25, dtype=torch.int64, device=dev)
        self.clw = torch.zeros(1, CLW // 8 + 16, dtype=torch.uint8, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # a warm-up loads the kernels
            _dynamic_header(self.up, self.clw)
        torch.cuda.current_stream(dev).wait_stream(side)
        counted = [k.launches for k in _GRAPH_KERNELS]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):  # a capture launches nothing
            self.out = _dynamic_header(self.up, self.clw)
        for k, n in zip(_GRAPH_KERNELS, counted):
            k.launches = n

    def __call__(self, up: np.ndarray, clw: torch.Tensor):
        self.up.copy_(torch.from_numpy(up).pin_memory(), non_blocking=True)
        self.clw.copy_(clw)
        self.graph.replay()
        for k in _GRAPH_KERNELS:
            k.launches += 1
        return self.out


# the hand kernels a replay launches once each, bound here so that their
# counters are found whatever later stands in for their names
_GRAPH_KERNELS = (visited_from_adv, mono_compact)
_GRAPHS: dict = {}  # card index -> its _HeaderGraph


def _header_graph(dev: torch.device) -> _HeaderGraph:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _GRAPHS:
        with torch.cuda.device(index):
            _GRAPHS[index] = _HeaderGraph(torch.device("cuda", index))
    return _GRAPHS[index]


def _huffman_block(arr, host, pos: int, out_total: int, end_bit: int):
    """Parse the Huffman block header at bit pos (static or dynamic), then
    tokenize its symbols in a PW-bit window from the byte of the first
    symbol.  Returns the tokenizer's (tk, ta, tb, ...), the host scalars
    (hdr_ok, min_len, kerr, ntok, outp, endp, base2, small) of the one
    device-to-host read, which is tallied on the open span, and the
    block's table and first symbol's bit on the device.  The
    header's host values go up without a wait; on a card a dynamic
    header's parse is one replay of ``_HeaderGraph``."""
    dev = arr.device
    i64 = torch.int64
    if _peek(host, pos + 1, 2) == 1:
        up = _upload(np.append(_STATIC_LENGTHS, [pos + 3, out_total]), dev)
        start = up[320:321]
        tab, min_len, hdr_ok = pack_block_tab(up[None, :288], up[None, 288:320],
                                              start & 7, up[321:])
    else:
        hlit = _peek(host, pos + 3, 5) + 257
        hdist = _peek(host, pos + 8, 5) + 1
        hclen = _peek(host, pos + 13, 4) + 4
        cl = np.zeros(19, np.int64)
        for j in range(hclen):
            cl[T.CODE_LENGTH_ORDER[j]] = _peek(host, pos + 17 + 3 * j, 3)
        cl_pos = pos + 17 + 3 * hclen
        up = np.append(cl, [cl_pos & 7, hlit + hdist, out_total, hlit, hdist, cl_pos])
        at = cl_pos >> 3  # the code lengths' bits, from a byte boundary
        clw = arr[None, at : at + CLW // 8 + 16]
        if dev.type == "cuda":
            tab, min_len, hdr_ok, start = _header_graph(dev)(up, clw)
        else:
            tab, min_len, hdr_ok, start = _dynamic_header(_upload(up, dev), clw)
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
    with tally("d2h"):
        hdr_ok, min_len, ntok, outp, endp, kerr, base2, small = scal.tolist()
    return (res[:3], (bool(hdr_ok), min_len, kerr, ntok, outp, endp, base2, bool(small)),
            tab, start)


def _lane_block(arr, end_bit: int, tab, start, tp: int, bufs, pwin: int):
    """Tokenize one Huffman block under its table tab int64[1, TAB_W]
    from its first symbol's bit start int64[1] with the lane tokenizer
    (``tokenize_dyn_batch``), which serves codes of any length, after the
    first tp tokens of bufs (tk, ta, tb int32[tok_cap]).  Returns the
    buffers and (tokens, output bytes, end bit, error), counted from the
    stream's start, from one device-to-host read tallied on the open
    span."""
    dev = arr.device
    i32 = torch.int32
    lane = _upload([end_bit, -1, tp], dev, i32)
    res = tokenize_dyn_batch(arr[None], lane[0:1], tab.to(i32), start.to(i32), lane[1:2],
                             lane[2:3], bufs[0].shape[0], pwin,
                             into=tuple(b[None] for b in bufs))
    with tally("d2h"):
        ntok, total, pos, err = torch.cat(res[3:7]).tolist()
    return tuple(t[0] for t in res[:3]), (ntok, total, pos, err)


def _lane_pwin(m_pad: int) -> int:
    """The lane tokenizer's pass window for a stream padded to m_pad
    bytes, as the general pipeline picks it (``ops.decode._pick_pwin``)."""
    return min(pow2_at_least(8 * m_pad), 1 << 17)


def _foreign_loop(arr: torch.Tensor, host: np.ndarray, start_bit: int,
                  end_bit: int, tok_cap: int, pwin: int):
    """Walk the blocks of the stream from start_bit: (mode, err, tk, ta,
    tb int32[K], tp, out_total, pos), the buffers of tok_cap tokens
    doubled while a block could overrun them; pwin is the lane tokenizer's
    pass window.  Counts on the open span the Huffman blocks walked (one
    device-to-host read each), those of them that the lane tokenizer
    walked again (one more read each), the stored blocks, and whether the
    walk reports FALLBACK; each wait for the card is tallied there too."""
    dev = arr.device
    tk, ta, tb = (torch.zeros(tok_cap, dtype=torch.int32, device=dev)
                  for _ in range(3))
    stored = []  # (slot, LEN, byte offset) of each stored block's token
    pos, mode, tp, total, err, it = start_bit, RUNNING, 0, 0, 0, 0
    huffman = lane = 0
    max_it = max((end_bit - start_bit) // 32 + 8, 8)
    while mode == RUNNING and pos < end_bit and it < max_it:
        if tp >= tk.shape[0] - (PW // 8 + 8192):
            # codes of a bit or two outrun a token per 3 bits of input
            tk, ta, tb = (torch.cat([t, torch.zeros_like(t)]) for t in (tk, ta, tb))
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
            huffman += 1
            toks, (hdr_ok, min_len, kerr, ntok, outp, endp, base2, small), tab, start = \
                _huffman_block(arr, host, pos, total, end_bit)
            fallback = False
            if hdr_ok and min_len < MIN_LIT_LEN_FOREIGN:
                # a 1-bit literal/length code: the lane tokenizer's block
                lane += 1
                (tk, ta, tb), (tp_after, total_after, end, kerr) = _lane_block(
                    arr, end_bit, tab, start, tp, (tk, ta, tb), pwin)
                fallback = kerr == ERR_OVERFLOW  # a block past the buffers
                ok = kerr == 0
                if ok:
                    pos, tp, total = end, tp_after, total_after
            else:
                # a bad header with such a code is the general pipeline's
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
        slot, ln, off = _upload(stored, dev).T
        tk[slot], ta[slot], tb[slot] = TK_STORED, ln.to(torch.int32), off.to(torch.int32)
    # running out of input without BFINAL is a truncated stream
    if mode == RUNNING:
        mode, err = FAILED, err or ERR_INPUT
    count("huffman_blocks", huffman)
    count("lane_blocks", lane)
    count("stored_blocks", len(stored))
    count("fallback", int(mode == FALLBACK))
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
    with span("td.api.h2d"):
        arr = torch.from_numpy(host).to(device)
    # the JAX package's capacity: a token per 3 bits of the padded input
    # and two token slabs of slack for the loop's guard
    tok_cap = (8 * m_pad) // 3 + 2 * (PW // 8 + 8192) + 16384
    tok_cap = -(-tok_cap // 1024) * 1024
    with span("td.decode.tokenize", arr.device):
        mode, err, tk, ta, tb, tp, total, pos = _foreign_loop(
            arr, host, start_bit, 8 * m, tok_cap, _lane_pwin(m_pad))
    if mode == FALLBACK:
        return None
    if mode != DONE:
        raise DeflateError(
            f"corrupt stream: {ERR_NAMES.get(err, f'error code {err}')}")
    out = expand_stream(arr, tk, ta, tb, tp, total)
    with span("td.api.d2h"):
        return out.cpu().numpy(), total, pos


def expand_stream(arr: torch.Tensor, tk: torch.Tensor, ta: torch.Tensor,
                  tb: torch.Tensor, tp: int, total: int) -> torch.Tensor:
    """A whole stream's tokens (the first tp of tk, ta, tb int32[K]) ->
    uint8 bytes, at least total of them: one row of a power of two up to
    SEG + 256 bytes, else segments (``expand_segments``), counted on the
    ``td.decode.expand`` span."""
    with span("td.decode.expand", arr.device):
        if total > SEG + 256:
            return expand_segments(arr, tk[:tp], ta[:tp], tb[:tp], total)
        count("segments", 1)
        live = max(tp, 1)  # the expanders index a row of at least one slot
        out, _ = expand(arr, tk[:live], ta[:live], tb[:live], tp,
                        max(1 << 12, pow2_at_least(total)))
        return out
