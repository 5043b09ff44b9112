"""Decode stage 1: one lane's bitstream -> tokens (``csrc/tokenize.cu``).

Each lane holds one byte-aligned run of stored and static-Huffman blocks
starting at bit 0 and ending at ``end_bits[b]``; the lane stops at its
first end-of-block.  The result is that of
``tpu_deflate.ops.decode.tokenize(static_only=True, stop_at_eob=True)``,
run on each lane with ``pwin`` bit positions per pass:

  tk, ta, tb  int32[B, tok_cap]  kind (TK_LIT / TK_MATCH / TK_STORED);
                                 literal byte, match length or stored
                                 length; 0, match distance or stored
                                 block's byte offset in the row
  ntok, out_total, end_pos, err  int32[B]

The JAX package decodes in passes of ``pwin`` bit positions, and a pass's
checks decide its error code in the order ERR_OVERFLOW (token capacity),
ERR_DIST (a distance before the output start), ERR_BAD_CODE; both
versions here walk the same passes, so they report the same code.  A
dynamic-tree block gives ERR_DYNAMIC, block type 3 ERR_METHOD.

With ``stop_at_eob=False`` a lane is one whole stream, as in ``tokenize(
stop_at_eob=False)``: the walk goes on after an end-of-block unless the
block was final (``one_block``: after the first block of any type), and
stops with ERR_DYNAMIC at a dynamic header's bit.  ``resume`` continues a
walk that another decoder took over for such a block: (tk, ta, tb, state)
with the token buffers so far and state int32[B, 3] = each lane's bit
position, token count and output bytes; ``later`` says that the header
there is not the stream's first.
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.kernels import build
from tpu_deflate_torch.spec import tables as T

ERR_OK = 0
ERR_METHOD = 1
ERR_BAD_CODE = 2
ERR_DIST = 4
ERR_OVERFLOW = 5
ERR_STORED = 6
ERR_INPUT = 7
ERR_DYNAMIC = 8
ERR_NAMES = {
    ERR_METHOD: "bad block method",
    ERR_BAD_CODE: "invalid Huffman code",
    ERR_DIST: "back-reference distance before stream start",
    ERR_OVERFLOW: "token capacity exceeded",
    ERR_STORED: "malformed stored block",
    ERR_INPUT: "truncated stream (ran past end without EOB)",
    ERR_DYNAMIC: "dynamic-Huffman block",
}

TK_LIT = 0
TK_MATCH = 1
TK_STORED = 2

# per-lane modes of the block loop
M_HEADER = 0
M_TOKENS = 3
M_DONE = 4
M_ERROR = 5

# the kernel's flags: go on after an end-of-block, end after any first
# block, the header at the resume position is not the stream's first
F_GO_ON = 1
F_ONE_BLOCK = 2
F_LATER = 4

# kinds of the symbol decoded at one bit position
K_LIT = 0
K_EOB = 1
K_MATCH = 2
K_BAD = 3


def _peek(rows: torch.Tensor, pos: torch.Tensor, nbits: int) -> torch.Tensor:
    """nbits (<= 24) bits at bit position pos of each row; rows int64[S, L]
    end in zero bytes, and reads past the end see those zeros."""
    byte = ((pos >> 3)[:, None] + torch.arange(4, device=rows.device))
    w = torch.gather(rows, 1, byte.clamp(max=rows.shape[1] - 1))
    acc = w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)
    return (acc >> (pos & 7)) & ((1 << nbits) - 1)


def bit_windows(rows: torch.Tensor, base: torch.Tensor, npos: int) -> torch.Tensor:
    """bits[s, k] = the stream of row s from bit base[s] + k on, at least
    49 bits valid, int64[S, npos].  rows int64[S, L] end in zero bytes,
    and reads past the end see those zeros."""
    dev = rows.device
    L = rows.shape[1]
    U = npos // 8 + 2
    bidx = ((base >> 3)[:, None] + torch.arange(U + 7, device=dev)).clamp(max=L - 1)
    bb = torch.gather(rows, 1, bidx)
    w = bb[:, :U].clone()
    for t in range(1, 7):  # 56-bit little-endian word at every byte
        w |= bb[:, t : t + U] << (8 * t)
    q = (base & 7)[:, None] + torch.arange(npos, device=dev)
    return torch.gather(w, 1, q >> 3) >> (q & 7)


def _static_plane(rows, base, end, pwin: int):
    """Candidate symbol at each of the pwin bit positions after base:
    (kind, adv, ta, tb) int64[S, pwin].  adv is the symbol's total width
    (1 for K_BAD); positions at or past end are K_BAD."""
    dev = rows.device
    bits = bit_windows(rows, base, pwin)

    tab = {k: torch.as_tensor(getattr(T, k), device=dev, dtype=torch.int64)
           for k in ("STATIC_LITLEN_TABLE", "STATIC_DIST_TABLE",
                     "LENGTH_EXTRA_BITS", "LENGTH_BASE", "DIST_EXTRA_BITS",
                     "DIST_BASE")}
    leaf = tab["STATIC_LITLEN_TABLE"][bits & 0x1FF]
    sym = leaf >> 4
    nb = leaf & 0xF
    bad = sym > 285
    is_lit = sym < 256
    is_eob = sym == 256
    i = (sym - 257).clamp(0, 28)
    ebits = tab["LENGTH_EXTRA_BITS"][i]
    length = tab["LENGTH_BASE"][i] + ((bits >> nb) & ((1 << ebits) - 1))
    is_m = ~is_lit & ~is_eob & ~bad
    doff = nb + torch.where(is_m, ebits, 0)
    dsym = tab["STATIC_DIST_TABLE"][(bits >> doff) & 31] >> 4
    bad |= is_m & (dsym > 29)
    dsym = dsym.clamp(max=29)
    debits = tab["DIST_EXTRA_BITS"][dsym]
    dist = tab["DIST_BASE"][dsym] + ((bits >> (doff + 5)) & ((1 << debits) - 1))

    kind = torch.where(is_lit, K_LIT, torch.where(is_eob, K_EOB, K_MATCH))
    oob = base[:, None] + torch.arange(pwin, device=dev) >= end[:, None]
    kind = torch.where(bad | oob, K_BAD, kind)
    is_m = kind == K_MATCH
    adv = torch.where(is_m, nb + ebits + 5 + debits,
                      torch.where(kind == K_BAD, 1, nb))
    ta = torch.where(kind == K_LIT, sym, torch.where(is_m, length, 0))
    tb = torch.where(is_m, dist, 0)
    return kind, adv, ta, tb


def new_lanes(B: int, tok_cap: int, device) -> dict:
    """Block-loop state of B lanes at bit 0: pos, mode, tp (tokens so far),
    total (output bytes so far), err int64[B]; tk, ta, tb int64[B,
    tok_cap + 1], whose spare last column takes the writes of positions
    that are not tokens."""
    i64 = torch.int64
    st = {k: torch.zeros(B, dtype=i64, device=device)
          for k in ("pos", "mode", "tp", "total", "err", "bfinal")}
    for k in ("tk", "ta", "tb"):
        st[k] = torch.zeros(B, tok_cap + 1, dtype=i64, device=device)
    return st


def block_pass(st: dict, s: torch.Tensor, plane, tok_cap: int) -> None:
    """One pass of the lanes s over their candidate plane (kind, adv, ta,
    tb) int64[S, pwin], taken from bit st["pos"][s]: the true symbols are
    the positions reachable from the first, and the pass ends at an
    end-of-block, a bad code, or the first symbol past the window.
    Updates st in place."""
    # ops.header imports this module, so its chase is looked up at call time
    from tpu_deflate_torch.ops.header import chase_reach

    kind, adv, tav, tbv = plane
    i64 = torch.int64
    pwin = kind.shape[1]
    base = st["pos"][s]
    term = (kind == K_EOB) | (kind == K_BAD)
    reach = chase_reach(adv, term)
    rel = torch.arange(pwin, device=kind.device)
    tmask = reach & ((kind == K_LIT) | (kind == K_MATCH))
    ordn = torch.cumsum(tmask, 1)
    ntok = ordn[:, -1]
    tp_s, tot_s = st["tp"][s], st["total"][s]
    cap_ok = tp_s + ntok < tok_cap - 1
    produced = torch.where(tmask, torch.where(kind == K_LIT, 1, tav), 0)
    before = tot_s[:, None] + torch.cumsum(produced, 1) - produced
    too_far = cap_ok & (tmask & (kind == K_MATCH) & (tbv > before)).any(1)
    bad = (reach & (kind == K_BAD)).any(1)
    eob = reach & (kind == K_EOB)
    eob_hit = eob.any(1)
    eob_rel = torch.where(eob, rel, -1).amax(1)
    last_rel = torch.where(reach, rel, -1).amax(1)
    stop = torch.where(eob_hit, eob_rel, last_rel)
    st["pos"][s] = base + stop + torch.gather(adv, 1, stop[:, None])[:, 0]

    slot = torch.where(tmask & cap_ok[:, None], tp_s[:, None] + ordn - 1,
                       tok_cap)
    st["tk"][s] = st["tk"][s].scatter(1, slot, (kind == K_MATCH).to(i64))
    st["ta"][s] = st["ta"][s].scatter(1, slot, tav)
    st["tb"][s] = st["tb"][s].scatter(1, slot, tbv)
    st["tp"][s] = tp_s + torch.where(cap_ok, ntok, 0)
    st["total"][s] = tot_s + torch.where(cap_ok, produced.sum(1), 0)

    anybad = bad | too_far | ~cap_ok
    st["mode"][s] = torch.where(anybad, M_ERROR,
                                torch.where(eob_hit, M_DONE, M_TOKENS))
    st["err"][s] = torch.where(
        anybad,
        torch.where(too_far, ERR_DIST,
                    torch.where(cap_ok, ERR_BAD_CODE, ERR_OVERFLOW)),
        st["err"][s],
    )


def in_bounds(st: dict, end: torch.Tensor, nbits: int, tok_cap: int):
    """bool[B]: the block loop may go on (pos inside the row and before
    the lane's end, token capacity left)."""
    pos = st["pos"]
    return (pos <= nbits) & (pos < end) & (st["tp"] < tok_cap - 1)


def finish(st: dict, end: torch.Tensor, tok_cap: int):
    """The block loop's results as int32: (tk, ta, tb, ntok, out_total,
    end_pos, err); a lane that stopped short of an end-of-block without
    an error reports ERR_OVERFLOW or ERR_INPUT."""
    mode, err, tp = st["mode"], st["err"], st["tp"]
    clean = (mode == M_DONE) | ((err == ERR_OK) & (st["pos"] >= end)
                                & (mode == M_HEADER))
    unfinished = torch.where(tp >= tok_cap - 1, ERR_OVERFLOW, ERR_INPUT)
    err = torch.where(clean | (err != ERR_OK), err, unfinished)
    i32 = torch.int32
    return (st["tk"][:, :tok_cap].to(i32), st["ta"][:, :tok_cap].to(i32),
            st["tb"][:, :tok_cap].to(i32), tp.to(i32), st["total"].to(i32),
            st["pos"].to(i32), err.to(i32))


def tokenize_static_plain(rows: torch.Tensor, end_bits: torch.Tensor,
                          tok_cap: int, pwin: int, stop_at_eob: bool = True,
                          one_block: bool = False, resume=None,
                          later: bool = False):
    """Plain version: the JAX package's block loop, vectorized over lanes.
    Each pass decodes a candidate at every bit position of its window and
    finds the true symbol starts with ``chase_reach``."""
    dev = rows.device
    B, M = rows.shape
    i64 = torch.int64
    ext = torch.nn.functional.pad(rows.to(i64), (0, pwin // 8 + 16))
    end = end_bits.to(i64)
    st = new_lanes(B, tok_cap, dev)
    if resume is not None:
        for k, buf in zip(("tk", "ta", "tb"), resume[:3]):
            st[k][:, :tok_cap] = buf
        for j, k in enumerate(("pos", "tp", "total")):
            st[k] += resume[3][:, j]
    pos, mode, tp, total, err, bfinal = (st[k] for k in (
        "pos", "mode", "tp", "total", "err", "bfinal"))
    eob_ends = stop_at_eob or one_block
    tk, ta, tb = st["tk"], st["ta"], st["tb"]
    lanes = torch.arange(B, device=dev)

    def active():
        return (mode < M_DONE) & in_bounds(st, end, 8 * M, tok_cap)

    def header(sel):
        s = lanes[sel]
        if s.numel() == 0:
            return
        p0, rs = pos[s], ext[s]
        bf = _peek(rs, p0, 1)
        bfinal[s] = bf
        btype = _peek(rs, p0 + 1, 2)
        # stored: LEN / NLEN at the next byte boundary, data after them
        p = (p0 + 3 + 7) & ~7
        ln = _peek(rs, p, 16)
        ok = ln == (_peek(rs, p + 16, 16) ^ 0xFFFF)
        st_ = btype == 0
        ss, slot = s[st_], tp[s][st_]
        tk[ss, slot] = TK_STORED
        ta[ss, slot] = ln[st_]
        tb[ss, slot] = (p[st_] + 32) >> 3
        tp[s] += st_.to(i64)
        total[s] += torch.where(st_, ln, 0)
        new_pos = torch.where(st_, p + 32 + 8 * ln,
                              torch.where(btype == 1, p0 + 3, p0))
        pos[s] = new_pos
        stored_mode = torch.where(
            ok, M_DONE if one_block else torch.where(bf == 1, M_DONE, M_HEADER),
            M_ERROR,
        )
        mode[s] = torch.where(
            st_, stored_mode, torch.where(btype == 1, M_TOKENS, M_ERROR)
        )
        code = torch.where(
            st_, torch.where(ok, err[s], ERR_STORED),
            torch.where(btype == 1, err[s],
                        torch.where(btype == 2, ERR_DYNAMIC, ERR_METHOD)),
        )
        err[s] = code

    def static_pass(sel):
        s = lanes[sel]
        if s.numel() == 0:
            return
        block_pass(st, s, _static_plane(ext[s], pos[s], end[s], pwin), tok_cap)
        if not eob_ends:  # an end-of-block ends the lane in a final block only
            m = mode[s]
            mode[s] = torch.where((m == M_DONE) & (bfinal[s] == 0), M_HEADER, m)

    if not later:
        header(active())  # the first header, then the block loop
    while True:
        live = active()
        if not bool(live.any()):
            break
        header(live & (mode == M_HEADER))
        static_pass(live & (mode == M_TOKENS))
    return finish(st, end, tok_cap)


def tokenize_static_batch(rows: torch.Tensor, end_bits: torch.Tensor,
                          tok_cap: int, pwin: int, stop_at_eob: bool = True,
                          one_block: bool = False, resume=None,
                          later: bool = False):
    """Tokenize rows uint8[B, M] up to end_bits int32[B].

    Returns (tk, ta, tb, ntok, out_total, end_pos, err), see the module
    docstring.  CPU tensors take the plain version; CUDA tensors launch
    the kernel, one block a lane, which appends to the token buffers of
    ``resume`` in place and otherwise fills fresh ones, zero past each
    lane's tokens."""
    if rows.device.type == "cpu":
        return tokenize_static_plain(rows, end_bits, tok_cap, pwin,
                                     stop_at_eob, one_block, resume, later)
    if rows.dtype != torch.uint8 or end_bits.dtype != torch.int32:
        raise ValueError("tokenize_static_batch: expects uint8 rows, "
                         "int32 end_bits")
    build.require_cuda("tokenize_static_batch", rows, end_bits)
    B, M = rows.shape
    dev = rows.device
    if resume is None:
        tk, ta, tb = (torch.empty(B, tok_cap, dtype=torch.int32, device=dev)
                      for _ in range(3))
        state_ptr = None
    else:
        tk, ta, tb, state = resume
        build.require_cuda("tokenize_static_batch", tk, ta, tb, state)
        if any(t.dtype != torch.int32 for t in resume) or any(
            t.shape != (B, tok_cap) for t in (tk, ta, tb)
        ) or state.shape != (B, 3):
            raise ValueError("tokenize_static_batch: resume expects int32 "
                             "[B, tok_cap] tokens and a [B, 3] state")
        state_ptr = state.data_ptr()
    flags = ((0 if stop_at_eob else F_GO_ON) | (F_ONE_BLOCK if one_block else 0)
             | (F_LATER if later else 0))
    ntok, out_total, end_pos, err = (
        torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4)
    )
    if B == 0:
        return tk, ta, tb, ntok, out_total, end_pos, err
    code = build.library().tokenize_static_launch(
        rows.data_ptr(), end_bits.data_ptr(), tk.data_ptr(), ta.data_ptr(),
        tb.data_ptr(), ntok.data_ptr(), out_total.data_ptr(),
        end_pos.data_ptr(), err.data_ptr(), state_ptr, flags, B, M, tok_cap,
        pwin, build.stream_handle(dev),
    )
    build.check(code, "tokenize_static")
    tokenize_static_batch.launches += 1
    return tk, ta, tb, ntok, out_total, end_pos, err


tokenize_static_batch.launches = 0
