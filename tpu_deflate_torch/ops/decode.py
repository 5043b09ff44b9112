"""The device decoder.  Stage 1 tokenizes a bitstream (``kernels/
tokenize.py`` for stored and static blocks, ``kernels/tokenize_dyn.py`` for
one static- or dynamic-tree block from per-lane code tables, with the
header parse of ``ops/header.py``), stage 2 expands the tokens into bytes
(``ops/expand.py``, and ``ops/foreign.py`` for a long stream's segments).
``decode_rows_batch`` decodes the indexed container's chunks as lanes;
``tokenize`` walks all blocks of one stream.  ``inflate_device`` /
``zlib_decompress_device`` decode any DEFLATE or zlib stream: on a CUDA
device through the device-paced decode of ``ops/foreign.py``, else, or
where that reports FALLBACK, through ``tokenize`` and the expansion.
``inflate_stream_step`` decodes a partial stream a block at a time, on
every device through ``tokenize``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_deflate_torch.config import DeflateConfig
from tpu_deflate_torch.kernels.tokenize import (
    ERR_BAD_CODE,
    ERR_DYNAMIC,
    ERR_INPUT,
    ERR_NAMES,
    ERR_OK,
    ERR_OVERFLOW,
    bit_windows,
    tokenize_static_batch,
)
from tpu_deflate_torch.kernels.tokenize_dyn import tokenize_dyn_batch
from tpu_deflate_torch.ops.checksum import adler32_fold_states, adler32_state
from tpu_deflate_torch.ops.expand import expand_batch, pow2_at_least
from tpu_deflate_torch.ops.foreign import expand_stream, inflate_foreign_device
from tpu_deflate_torch.ops.header import (
    CL_WIN,
    MAX_SYMS,
    canon_params,
    decode_cl_lengths,
    pack_block_tab,
)
from tpu_deflate_torch.ref.inflate import DeflateError
from tpu_deflate_torch.spec import tables as T
from tpu_deflate_torch.utils.profiling import span


def chunk_pwin(chunk: int) -> int:
    """Bit positions per tokenizer pass for chunk-parallel decode: 17 * 2^k
    (the JAX package's plane window, which fixes where its passes split
    and so which error a pass reports)."""
    k = max(6, min(14, math.ceil(math.log2(max(chunk, 64))) - 2))
    return 17 << k


def _static(name: str, dev) -> torch.Tensor:
    return torch.as_tensor(getattr(T, name), dtype=torch.int64, device=dev)


def dyn_header_params_batch(rows: torch.Tensor, ends: torch.Tensor,
                            base: torch.Tensor | None = None,
                            out_base: torch.Tensor | None = None,
                            first=None):
    """Parse the block header at bit base[b] (default 0, the first block)
    of each lane of rows uint8[B, M] with end bits ends int32[B];
    out_base[B] counts the lane's output bytes before that block (default
    0) and goes into the table.  ``first`` (a bool, or bool[B]) says
    whether that header is the lane's first (default: where base is 0).

    Returns the dict of ``tpu_deflate.ops.decode.dyn_header_params_batch``
    (which parses bit 0) as int32: ok (a static block, or a dynamic one
    with valid trees, or an empty lane), start (bit of the first symbol),
    min_len, tab[B, TAB_W]; and, for the decoder, btype and status: -1
    where the lane's symbols are to be decoded from start, else the error
    code with which the JAX package's block loop ends the lane in this
    header (no more tokens, end bit stop)."""
    B, M = rows.shape
    dev = rows.device
    i64 = torch.int64
    ext = torch.nn.functional.pad(rows.to(i64), (0, CL_WIN // 8 + 64))
    end = ends.to(i64)
    base = (torch.zeros(B, dtype=i64, device=dev) if base is None
            else base.to(i64))
    hdr = bit_windows(ext, base, 17 + 3 * 19)
    btype = (hdr[:, 1] & 3)
    hlit = (hdr[:, 3] & 31) + 257
    hdist = (hdr[:, 8] & 31) + 1
    hclen = (hdr[:, 13] & 15) + 4
    j = torch.arange(19, device=dev)
    raw = torch.where(j < hclen[:, None], hdr[:, 17 + 3 * j] & 7, 0)
    order = torch.as_tensor(T.CODE_LENGTH_ORDER, dtype=i64, device=dev)
    cl_lengths = torch.zeros(B, 19, dtype=i64, device=dev).scatter(
        1, order.expand(B, 19), raw)
    clim, crd, csym, cover = canon_params(cl_lengths, 19)
    pos0 = base + 17 + 3 * hclen
    lengths, end_next, cl_ok = decode_cl_lengths(
        ext, pos0, hlit + hdist, clim, crd, csym)
    sidx = torch.arange(MAX_SYMS, device=dev)
    dyn_lit = torch.where(sidx < hlit[:, None], lengths, 0)[:, :288]
    d = torch.arange(32, device=dev)
    dl = torch.gather(lengths, 1, (hlit[:, None] + d).clamp(0, MAX_SYMS - 1))
    dyn_dist = torch.where(d < hdist[:, None], dl, 0)

    is_static = (btype == 1)[:, None]
    lit_lengths = torch.where(is_static, _static("STATIC_LITLEN_LENGTHS", dev),
                              dyn_lit)
    dist_lengths = torch.where(is_static, _static("STATIC_DIST_LENGTHS", dev),
                               dyn_dist)
    dyn_start = pos0 + end_next
    start = torch.where(btype == 1, base + 3, dyn_start)
    if first is None:
        first = base == 0
    elif not isinstance(first, torch.Tensor):
        first = torch.full_like(base, first, dtype=torch.bool)
    empty = first & (end <= base + 3)
    start = torch.where(empty, base, start)
    tab, min_len, trees_ok = pack_block_tab(lit_lengths, dist_lengths, start,
                                            out_base)
    ok = empty | (btype == 1) | ((btype == 2) & cl_ok & ~cover & trees_ok)
    min_len = torch.where(empty, 99, min_len)

    # where the block loop stops: the header at base runs if base < end (a
    # later header, after stored blocks, is only reached so).  The first
    # header is followed by a bounds check: a static block's symbols need
    # base + 3 < end, a dynamic block's code lengths pos0 < end.  A later
    # header runs on into its first pass.  A dynamic header fails on an
    # oversubscribed code-length code, then on lengths that do not decode
    # or oversubscribed trees.  Otherwise the first pass runs from start.
    nbits = 8 * M
    fits3 = ~first | ((base + 3 < end) & (base + 3 <= nbits))
    fits0 = ~first | ((pos0 < end) & (pos0 <= nbits))
    status = torch.where(
        btype == 1, torch.where(fits3, -1, ERR_INPUT),
        torch.where(cover, ERR_BAD_CODE,
                    torch.where(~fits0, ERR_INPUT,
                                torch.where(cl_ok & trees_ok, -1,
                                            ERR_BAD_CODE))))
    stop = torch.where(btype == 1, base + 3,
                       torch.where(cover | ~fits0, pos0, dyn_start))
    runs = base < end
    status = torch.where(runs, status, ERR_OK)
    stop = torch.where(runs, stop, base)
    i32 = torch.int32
    return dict(
        ok=ok.to(i32), start=start.to(i32), min_len=min_len.to(i32),
        tab=tab.to(i32), btype=btype.to(i32), status=status.to(i32),
        stop=stop.to(i32),
    )


def dyn_lanes(prep: dict):
    """From a header parse: (coded bool[B] = the block has Huffman codes,
    and the starts and status int32[B] that ``tokenize_dyn_batch`` takes;
    a lane that is not coded gets status ERR_OK, no work)."""
    coded = (prep["btype"] == 1) | (prep["btype"] == 2)
    starts = torch.where(prep["status"] < 0, prep["start"], prep["stop"])
    return coded, starts, torch.where(coded, prep["status"], ERR_OK)


def tokenize_rows_batch(rows: torch.Tensor, ends: torch.Tensor, tok_cap: int,
                        pwin: int, static_only: bool = True,
                        starts: torch.Tensor | None = None):
    """Stage 1 of ``decode_rows_batch``: (tk, ta, tb, ntok, out_total,
    end_pos, err) of each lane, see ``kernels.tokenize``.

    ``static_only`` decodes stored and static blocks and reports a
    dynamic-tree block as ERR_DYNAMIC.  Otherwise a lane whose first block
    has Huffman codes (static or dynamic) is decoded by
    ``tokenize_dyn_batch`` from its parsed header, and a lane whose first
    block is stored or of type 3 by ``tokenize_static_batch``.  Where the
    static kernel stops at a dynamic block after stored ones, the dynamic
    kernel parses that header and goes on from the static kernel's tokens
    and output.  Both kernels run over the whole batch.

    ``starts`` int32[B] (default 0) is the bit of each row at which its
    first header lies, as ``tokenize``'s start bit; the static kernel then
    resumes from it with no tokens and no output."""
    ends = ends.to(torch.int32)
    B, M = rows.shape
    dev = rows.device
    resume = None
    base = torch.zeros(B, dtype=torch.int32, device=dev)
    if starts is not None:
        base = starts.to(torch.int32)
        zero = torch.zeros_like(base)
        resume = (*(torch.zeros(B, tok_cap, dtype=torch.int32, device=dev)
                    for _ in range(3)),
                  torch.stack([base, zero, zero], 1).contiguous())
    if static_only:
        return tokenize_static_batch(rows, ends, tok_cap, pwin, resume=resume)
    head = torch.nn.functional.pad(rows[:, :2].to(torch.int32), (0, 2 - min(M, 2)))
    btype = ((head[:, 0] | (head[:, 1] << 8)) >> (base + 1)) & 3
    huff = (btype == 1) | (btype == 2)
    st = tokenize_static_batch(rows, torch.where(huff, 0, ends), tok_cap, pwin,
                               resume=resume)
    after = st[6] == ERR_DYNAMIC
    prep = dyn_header_params_batch(rows, ends, torch.where(after, st[5], base),
                                   torch.where(after, st[4], 0), first=~after)
    coded, sym_starts, status = dyn_lanes(prep)
    tok0 = torch.where(after, st[3], 0)
    dyn = tokenize_dyn_batch(rows, ends, prep["tab"], sym_starts, status, tok0,
                             tok_cap, pwin)
    take = coded[:, None] & (torch.arange(tok_cap, device=dev)
                             >= tok0[:, None])
    return tuple(torch.where(take if d.dim() == 2 else coded, d, s)
                 for d, s in zip(dyn, st))


def decode_rows_batch(rows: torch.Tensor, ends: torch.Tensor, out_cap: int,
                      tok_cap: int, static_only: bool = True,
                      starts: torch.Tensor | None = None,
                      stored_rows: torch.Tensor | None = None):
    """Chunk-parallel decode of per-lane rows uint8[B, M], each one run of
    blocks from bit starts[b] (default 0) to bit ends[b].  Lanes stop at
    their first end-of-block.  Returns (out uint8[B, out_cap], totals
    int32[B], errs int32[B]); ``static_only`` and ``starts`` as in
    ``tokenize_rows_batch``.  A stored block's bytes are copied from
    ``stored_rows`` (default rows), of the same shape."""
    with span("td.decode.tokenize", rows.device):
        tk, ta, tb, tp, _tot, _pos, err = tokenize_rows_batch(
            rows, ends, tok_cap, chunk_pwin(out_cap), static_only, starts)
    src = rows if stored_rows is None else stored_rows
    with span("td.decode.expand", rows.device):
        out, total = expand_batch(src, tk, ta, tb, tp, out_cap)
    return out, total, err


# ---------------------------------------------------------------------------
# One stream of many blocks
# ---------------------------------------------------------------------------


def tokenize(data: torch.Tensor, start_bit: int, tok_cap: int,
             end_bit: int | None = None, pwin: int = 1 << 18,
             static_only: bool = False, one_block: bool = False,
             stop_at_eob: bool = False, return_bfinal: bool = False):
    """Stage 1 of a whole stream: all blocks of data uint8[M] from
    start_bit up to the final block -> (tk, ta, tb int32[tok_cap], tp,
    out_total, end_pos, err), the last four Python ints; the result of
    ``tpu_deflate.ops.decode.tokenize`` with the same ``pwin``,
    ``static_only`` (a dynamic block is ERR_DYNAMIC), ``one_block`` (the
    first block of any type ends the stream) and ``stop_at_eob`` (the
    first Huffman block's end-of-block ends the walk; stored blocks do
    not, unless final).  ``return_bfinal`` appends the BFINAL bit of the
    block in which the walk stopped; it needs ``stop_at_eob``.

    The block loop runs on the host, over the two tokenizer kernels: the
    static kernel walks stored and static blocks until the stream ends or a
    dynamic header stops it; that header is parsed on the device and the
    dynamic kernel decodes its block into the same token buffers, with
    distances bounded by all output so far.  After each kernel the host
    reads the lane's four counters, and it reads block types, and BFINAL,
    from its own copy of the stream."""
    if return_bfinal and not stop_at_eob:
        raise ValueError("tokenize: return_bfinal needs stop_at_eob")
    dev = data.device
    M = data.shape[0]
    nbits = 8 * M
    end = nbits if end_bit is None else int(end_bit)
    host = data.cpu().numpy()
    rows = data[None]
    ends = torch.tensor([end], dtype=torch.int32, device=dev)
    tk, ta, tb = (torch.zeros(1, tok_cap, dtype=torch.int32, device=dev)
                  for _ in range(3))
    pos, tp, total, err, bfinal = int(start_bit), 0, 0, ERR_OK, 0
    first = True

    def counters(res):
        return (int(x) for x in torch.cat(res[3:7]).tolist())

    while True:
        if not (pos <= nbits and pos < end and tp < tok_cap - 1):
            if pos < end:  # stopped short of the end, not at a block's edge
                err = ERR_OVERFLOW if tp >= tok_cap - 1 else ERR_INPUT
            break
        hdr = _bits(host, pos, 3)
        state = torch.tensor([[pos, tp, total]], dtype=torch.int32, device=dev)
        if (hdr >> 1) & 3 == 2 and not static_only:
            prep = dyn_header_params_batch(rows, ends, state[:, 0], state[:, 2],
                                           first)
            _coded, starts, status = dyn_lanes(prep)
            res = tokenize_dyn_batch(rows, ends, prep["tab"], starts, status,
                                     state[:, 1].contiguous(), tok_cap, pwin,
                                     into=(tk, ta, tb))
            tk, ta, tb = res[:3]
            tp, total, pos, err = counters(res)
            bfinal = hdr & 1
            if err != ERR_OK or hdr & 1 or one_block or stop_at_eob:
                break
        else:
            walked = pos
            res = tokenize_static_batch(
                rows, ends, tok_cap, pwin, stop_at_eob=stop_at_eob,
                one_block=one_block, resume=(tk, ta, tb, state),
                later=not first)
            tk, ta, tb = res[:3]
            tp, total, pos, err = counters(res)
            if return_bfinal:
                bfinal = _last_bfinal(host, walked, pos)
            if err != ERR_DYNAMIC or static_only:
                break
            err = ERR_OK  # the dynamic block at pos is decoded next
        first = False
    if return_bfinal:
        return tk[0], ta[0], tb[0], tp, total, pos, err, bfinal
    return tk[0], ta[0], tb[0], tp, total, pos, err


def _bits(host: np.ndarray, pos: int, nbits: int) -> int:
    """nbits (<= 9) bits at bit pos of a host copy of the stream; bytes
    past its end read as zero."""
    byte = pos >> 3
    return ((int.from_bytes(host[byte : byte + 2].tobytes(), "little")
             >> (pos & 7)) & ((1 << nbits) - 1))


def _last_bfinal(host: np.ndarray, pos: int, stop: int) -> int:
    """BFINAL of the block in which a walk under ``stop_at_eob`` that
    started at bit pos stopped at bit stop: the walk passes stored blocks
    (skipped here by their LEN) up to a final one or a Huffman block,
    where it ends."""
    while True:
        hdr = _bits(host, pos, 3)
        if hdr & 1 or (hdr >> 1) & 3:
            return hdr & 1
        p = (pos + 3 + 7) & ~7
        pos = p + 32 + 8 * (_bits(host, p, 8) | _bits(host, p + 8, 8) << 8)
        if pos >= stop:
            return 0


def _pick_pwin(nbytes: int) -> int:
    """Bit positions per tokenizer pass for a stream of nbytes: the power
    of two that covers it, at most 2^17 (the JAX package's rule, which
    fixes where its passes split and so which error a pass reports)."""
    return min(pow2_at_least(8 * max(nbytes, 64)), 1 << 17)


def inflate_device(data, start_bit: int = 0, out_cap: int | None = None,
                   static_only: bool = False, one_block: bool = False,
                   device="cuda"):
    """Inflate a raw DEFLATE stream (bytes or a uint8 array) on ``device``
    from start_bit on.  Returns (uint8 numpy array, output length, end
    bit).  ``static_only`` refuses dynamic-tree blocks; ``one_block``
    stops after the first block.  Raises DeflateError on a corrupt stream.

    On a CUDA device, unless ``static_only`` or ``one_block`` is set, the
    device-paced decode of ``ops.foreign`` runs first, as the JAX package
    runs it on the TPU; a stream that it cannot serve (FALLBACK) and every
    stream on the CPU go through the general pipeline."""
    if not static_only and not one_block and torch.device(device).type == "cuda":
        done = inflate_foreign_device(data, start_bit, device)
        if done is not None:
            return done
    return _inflate_general(data, start_bit, out_cap, static_only, one_block,
                            device)


def _inflate_general(data, start_bit: int = 0, out_cap: int | None = None,
                     static_only: bool = False, one_block: bool = False,
                     device="cuda"):
    """The general pipeline of ``inflate_device``: the block walk of
    ``tokenize``, then the expansion.  The token capacity starts at four
    bytes of output per byte of input and doubles while the tokenizer
    reports ERR_OVERFLOW.

    The stream is followed by zero bytes up to a power of two, as in the
    JAX package, and decoding is bounded by that length: a stream cut
    short decodes on into the zeros, and the error it reports is found
    there."""
    raw = np.frombuffer(bytes(data), dtype=np.uint8)
    m = len(raw)
    m_pad = max(1 << 12, pow2_at_least(m))
    with span("td.api.h2d"):
        arr = torch.from_numpy(np.pad(raw, (0, m_pad - m))).to(device)
    cap = out_cap or max(1 << 12, pow2_at_least(4 * m))
    pwin = _pick_pwin(m_pad)
    with span("td.decode.tokenize", arr.device):
        while True:
            tk, ta, tb, tp, total, pos, err = tokenize(
                arr, start_bit, cap + 16, pwin=pwin, static_only=static_only,
                one_block=one_block)
            if err == ERR_OVERFLOW or (err == ERR_OK and total > cap):
                cap *= 2
                if cap > 1 << 31:
                    raise ValueError("output too large")
                continue
            if err == ERR_DYNAMIC:
                raise DeflateError(
                    "dynamic-Huffman block rejected: decoder compiled with "
                    "dynamic=False/low_lut (reference DYNAMIC flag, "
                    "deflate.py:25)"
                )
            if err != ERR_OK:
                raise DeflateError(
                    f"corrupt stream: {ERR_NAMES.get(err, f'error code {err}')}"
                )
            break
    out = expand_stream(arr, tk, ta, tb, tp, total)
    with span("td.api.d2h"):
        return out.cpu().numpy(), total, pos


def _shift_right_bits(data: bytes, k: int) -> bytes:
    """Drop the low k bits (0-7) of an LSB-first bitstream: output byte i
    carries input bits [8i + k, 8i + k + 8)."""
    if k == 0:
        return bytes(data)
    a = np.frombuffer(bytes(data), np.uint8).astype(np.uint16)
    nxt = np.concatenate([a[1:], np.zeros(1, np.uint16)])
    return (((a >> k) | ((nxt << (8 - k)) & 0xFF)) & 0xFF).astype(np.uint8).tobytes()


def inflate_stream_step(window: bytes, pending: bytes, pbit: int,
                        static_only: bool = False, device="cuda"):
    """One step of an incremental inflate on ``device``: the next run of
    blocks of a partial stream, up to the first Huffman block's
    end-of-block.  ``window`` is the last <= 32 KiB of output so far;
    ``pending`` the compressed bytes not consumed yet, of whose first byte
    the low ``pbit`` bits are.  Returns (emitted bytes, bits of pending
    consumed, whether that block was final); (b"", 0, False) where the
    block is not all buffered yet (or is corrupt: the caller's flush finds
    that), so the caller feeds more input and tries again.  Raises
    DeflateError on a dynamic block under ``static_only``.

    The stream decoded is a stored block that carries the window, so the
    block's distances reach into it, then pending shifted by pbit,
    bounded by its end bit; the walk is ``tokenize``'s, with the token
    capacity doubled while it overflows."""
    W = len(window)
    if W > 0xFFFF:  # the JAX package's type (an assert there)
        raise AssertionError("a stored block carries at most 65535 bytes")
    prefix = (b"\x00" + W.to_bytes(2, "little") + (W ^ 0xFFFF).to_bytes(2, "little")
              + bytes(window))
    raw = np.frombuffer(prefix + _shift_right_bits(pending, pbit), np.uint8)
    m = len(raw)
    m_pad = max(1 << 12, pow2_at_least(m))
    arr = torch.from_numpy(np.pad(raw, (0, m_pad - m))).to(device)
    end_bit = 8 * len(prefix) + 8 * len(pending) - pbit
    cap = max(1 << 12, pow2_at_least(W + 4 * len(pending)))
    pwin = _pick_pwin(m_pad)
    while True:
        tk, ta, tb, tp, total, pos, err, bfinal = tokenize(
            arr, 0, cap + 16, end_bit=end_bit, pwin=pwin,
            static_only=static_only, stop_at_eob=True, return_bfinal=True)
        if err == ERR_OVERFLOW or (err == ERR_OK and total > cap):
            cap *= 2
            if cap > 1 << 31:
                raise ValueError("output too large")
            continue
        if err == ERR_DYNAMIC:
            raise DeflateError(
                "dynamic-Huffman block rejected: decoder compiled with "
                "dynamic=False/low_lut (reference DYNAMIC flag, "
                "deflate.py:25)"
            )
        # a block cut short (or corrupt), or parsed past the buffered
        # input (a stored payload cut after its header): wait for more
        consumed = pos - 8 * len(prefix)
        if err != ERR_OK or pos > end_bit or consumed <= 0:
            return b"", 0, False
        out = expand_stream(arr, tk, ta, tb, tp, total)
        return out[W:total].cpu().numpy().tobytes(), consumed, bool(bfinal)


def zlib_decompress_device(data: bytes, config: DeflateConfig = DeflateConfig(),
                           device="cuda") -> bytes:
    """RFC 1950 unwrap, inflate on ``device``, Adler-32 check.
    ``config.dynamic=False`` or ``low_lut`` refuse dynamic-tree blocks,
    ``one_block`` stops after the first block."""
    if len(data) < 6:
        raise DeflateError("zlib stream too short")
    cmf, flg = data[0], data[1]
    if cmf & 0x0F != 8 or (cmf << 8 | flg) % 31 != 0:
        raise DeflateError("bad zlib header")
    out, total, end_bit = inflate_device(
        data, start_bit=16, static_only=config.low_lut or not config.dynamic,
        one_block=config.one_block, device=device,
    )
    trailer_at = (end_bit + 7) // 8
    expect = int.from_bytes(data[trailer_at : trailer_at + 4], "big")
    with span("td.api.h2d"):
        again = torch.from_numpy(out[:total]).to(device)
    got = _adler32(again)
    if got != expect:
        raise DeflateError(f"Adler-32 mismatch {got:#x} != {expect:#x}")
    return out[:total].tobytes()


def _adler32(data: torch.Tensor) -> int:
    """Adler-32 of data uint8[n], as 64 KiB chunk states folded in order."""
    chunk = 1 << 16
    n = data.shape[0]
    nchunks = max(1, -(-n // chunk))
    with span("td.checksum.adler"):
        rows = torch.nn.functional.pad(data, (0, nchunks * chunk - n))
        lens = (n - chunk * torch.arange(nchunks, device=data.device)).clamp(0, chunk)
        a, b = adler32_state(rows.reshape(nchunks, chunk), lens)
        fa, fb, _ = adler32_fold_states(a, b, lens)
    # the first wait after the checksum: its scalars come after it on the stream
    with span("td.api.d2h"):
        return (int(fb) << 16) | int(fa)
