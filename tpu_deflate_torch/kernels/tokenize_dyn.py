"""Decode stage 1 for one static- or dynamic-tree block per lane, from
per-lane code tables, in two forms.

The header of each lane's block is parsed beforehand
(``ops.decode.dyn_header_params_batch``, or the block loop of
``ops.foreign``), which packs the lane's canonical code parameters into a
table of TAB_W int32 (layout below, that of
``tpu_deflate.kernels.tokenize_dyn``) and gives the bit where its first
symbol starts.  A symbol is decoded by comparison: its code length is the
first L whose limit lim[L] exceeds the 15-bit MSB-first prefix, its rank
is prefix >> (15 - L) plus rd[L], and the rank names the symbol.

``tokenize_dyn_batch`` (``csrc/tokenize_dyn.cu``) decodes each lane with
one thread block, in the static tokenizer's passes: the symbol starts of
a pass's window by a fixed-point iteration over subsequences, under the
lane's tables in shared memory.  Inputs per lane: rows uint8[B, M],
end_bits int32[B], tab int32[B, TAB_W], starts int32[B], status int32[B]
and tok0 int32[B].  The block may follow earlier blocks of the lane
(stored ones): tok0 tokens and tab[TAB_OUTBASE] output bytes came before
it, its tokens take the slots from tok0 on, matches may reach into that
output, and ntok and out_total count it.  A lane with status < 0 is
decoded from bit starts[b]; a lane with status >= 0 ended in its header
and reports err = status, no new tokens and end_pos = starts[b].  Outputs
are those of ``kernels.tokenize.tokenize_static_batch``; it is held
against ``tpu_deflate.ops.decode.tokenize(static_only=False,
stop_at_eob=True)`` on each lane, decoded in passes of ``pwin`` bit
positions with the same error precedence (ERR_OVERFLOW, ERR_DIST,
ERR_BAD_CODE within a pass).  ``into`` = (tk, ta, tb) int32[B, tok_cap]
holds the lane's earlier tokens; the block's tokens are added to them (the
kernel writes them in place).

``tokenize_dyn_hier`` (``csrc/tokenize_hier.cu`` and
``kernels.chase1.ent_from_phi``) decodes ONE lane tile-parallel, for the
device-paced stream decode: a candidate symbol at every bit position of a
``pw``-bit window, the transfer map of each 64-bit tile, the entry phase
of each tile by composing the maps, and a walk of at most 33 visits in
every tile at once.  It is held against ``tpu_deflate.kernels.
tokenize_dyn.tokenize_dyn_batch(hier=True, tier=2)``: the same tokens,
counts, end bit and error, with that kernel's capacity and its rules (a
distance may reach tab[TAB_OUTBASE] bytes before the block; ERR_DIST, then
ERR_OVERFLOW, then ERR_BAD_CODE for a bad symbol on the orbit, else ERR_OK
at an end-of-block and ERR_INPUT without one).  Its inputs: every
literal/length code at least MIN_LIT_LEN_FOREIGN bits, the first symbol
in the first tile (starts[0] < 64), pw / 64 a power of two and a multiple
of 128.
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.kernels import build
from tpu_deflate_torch.kernels.chase1 import (
    STOP,
    TILE,
    ent_from_phi,
    ent_from_phi_plain,
)
from tpu_deflate_torch.kernels.tokenize import (
    ERR_BAD_CODE,
    ERR_DIST,
    ERR_INPUT,
    ERR_OK,
    ERR_OVERFLOW,
    K_BAD,
    K_EOB,
    K_LIT,
    K_MATCH,
    M_DONE,
    M_TOKENS,
    bit_windows,
    block_pass,
    finish,
    in_bounds,
    new_lanes,
)

# packed per-lane table layout
TAB_LIT_LIM = 0
TAB_LIT_RD = 16
TAB_DIST_LIM = 32
TAB_DIST_RD = 48
TAB_SYM8 = 64  # 72 rows: 4 x 8-bit low bytes of (sym + 1), 0 = dead rank
TAB_SYMHI = 136  # 9 rows: 32 x 1-bit bit 8 of (sym + 1)
TAB_DSYM8 = 145  # 8 rows: 4 x 8-bit (dsym + 1), 0 = dead rank
# then the first symbol's bit and the shortest literal/length code
TAB_OUTBASE = 155  # output bytes of the lane before the block
TAB_W = 160

# symbol visits per 64-bit tile in the tile-parallel form: 64 / (shortest
# literal/length code) symbols and a terminator; the indexed container's
# lanes need codes of 3 bits (tier 3), the stream decode 2 (tier 2)
WLK_BY_TIER = {3: 22, 2: 33}
MIN_LIT_LEN_FOREIGN = 2
HIER_WLK = WLK_BY_TIER[2]
K3D_TILES = 128  # csrc/tokenize_hier.cu's kK3Tiles: tiles one block of K3d walks
K1D_BITS = 2048  # csrc/tokenize_hier.cu's kK1Bits: bit positions one block of K1d decodes


def rank_symbols(tab: torch.Tensor):
    """The rank -> symbol tables of each lane's packed table: (lit int64[B,
    288], dist int64[B, 32]) holding sym + 1, 0 for a dead rank."""
    t = tab.to(torch.int64) & 0xFFFFFFFF
    dev = tab.device
    r = torch.arange(288, device=dev)
    lo = (t[:, TAB_SYM8 + (r >> 2)] >> ((r & 3) << 3)) & 0xFF
    hi = (t[:, TAB_SYMHI + (r >> 5)] >> (r & 31)) & 1
    d = torch.arange(32, device=dev)
    dist = (t[:, TAB_DSYM8 + (d >> 2)] >> ((d & 3) << 3)) & 0xFF
    return lo | (hi << 8), dist


def rev15(x: torch.Tensor) -> torch.Tensor:
    """The low 15 bits of x, MSB first: bit-reversed."""
    x = x & 0x7FFF
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 1


def code_rank(prefix: torch.Tensor, lim: torch.Tensor, rd: torch.Tensor):
    """Comparison decode of MSB-first 15-bit prefixes int64[S, P] against
    each row's (lim, rd) int64[S, 16], lim nondecreasing as
    ``ops.header.canon_params`` makes it: (code length, 16 where no code
    matches; the length clipped to [1, 15]; rank).  The length is one
    more than the limits lim[1:] at most the prefix, found by one search."""
    nb = 1 + torch.searchsorted(lim[:, 1:].contiguous(), prefix, right=True)
    nbc = nb.clamp(1, 15)
    return nb, nbc, (prefix >> (15 - nbc)) + torch.gather(rd, 1, nbc)


def _dyn_plane(rows, base, end, pwin: int, tab, lit_sym, dist_sym):
    """Candidate symbol at each of the pwin bit positions after base under
    each lane's tables: (kind, adv, ta, tb) int64[S, pwin].  adv is the
    symbol's total width (1 for K_BAD); positions at or past end are
    K_BAD."""
    dev = rows.device
    bits = bit_windows(rows, base, pwin)
    t = tab.to(torch.int64)

    def field(shift, nbits):
        return (bits >> shift) & ((1 << nbits) - 1)

    nb, nbc, rank = code_rank(rev15(bits), t[:, TAB_LIT_LIM : TAB_LIT_LIM + 16],
                              t[:, TAB_LIT_RD : TAB_LIT_RD + 16])
    symp1 = torch.gather(lit_sym, 1, rank.clamp(0, 287))
    bad = (nb > 15) | (rank < 0) | (rank >= 288) | (symp1 == 0)
    sym = (symp1 - 1).clamp(0, 287)
    is_lit = sym < 256
    is_eob = sym == 256
    bad |= sym > 285
    i = (sym - 257).clamp(0, 28)
    ebits = ((i >> 2) - 1).clamp(0, 5)
    lbase = torch.where(i < 8, i + 3, ((4 + (i & 3)) << ebits) + 3)
    lbase = torch.where(i == 28, 258, lbase)
    ebits = torch.where(i == 28, 0, ebits)
    is_m = ~is_lit & ~is_eob & ~bad
    ebits = torch.where(is_m, ebits, 0)
    length = lbase + (field(nbc, 5) & ((1 << ebits) - 1))

    doff = nbc + ebits
    dnb, dnbc, drank = code_rank(rev15(bits >> doff),
                                 t[:, TAB_DIST_LIM : TAB_DIST_LIM + 16],
                                 t[:, TAB_DIST_RD : TAB_DIST_RD + 16])
    dsymp1 = torch.gather(dist_sym, 1, drank.clamp(0, 31))
    bad_d = (dnb > 15) | (drank < 0) | (drank >= 32) | (dsymp1 == 0)
    dsym = (dsymp1 - 1).clamp(0, 29)
    debits = ((dsym >> 1) - 1).clamp(0, 13)
    dbase = torch.where(dsym < 2, dsym + 1, ((2 + (dsym & 1)) << debits) + 1)
    dist = dbase + (field(doff + dnbc, 13) & ((1 << debits) - 1))

    kind = torch.where(is_lit, K_LIT, torch.where(is_eob, K_EOB, K_MATCH))
    oob = base[:, None] + torch.arange(pwin, device=dev) >= end[:, None]
    kind = torch.where(bad | (is_m & bad_d) | oob, K_BAD, kind)
    is_m = kind == K_MATCH
    adv = torch.where(is_m, nbc + ebits + dnbc + debits,
                      torch.where(kind == K_BAD, 1, nbc))
    ta = torch.where(kind == K_LIT, sym, torch.where(is_m, length, 0))
    return kind, adv, ta, torch.where(is_m, dist, 0)


def tokenize_dyn_plain(rows: torch.Tensor, end_bits: torch.Tensor,
                       tab: torch.Tensor, starts: torch.Tensor,
                       status: torch.Tensor, tok0: torch.Tensor,
                       tok_cap: int, pwin: int, into=None):
    """Plain version: the JAX package's block passes, vectorized over
    lanes; each pass decodes a candidate under the lane's tables at every
    bit position of its window and finds the true symbol starts with
    ``chase_reach``."""
    dev = rows.device
    B, M = rows.shape
    i64 = torch.int64
    ext = torch.nn.functional.pad(rows.to(i64), (0, pwin // 8 + 16))
    end = end_bits.to(i64)
    status = status.to(i64)
    lit_sym, dist_sym = rank_symbols(tab)
    st = new_lanes(B, tok_cap, dev)
    if into is not None:
        for k, buf in zip(("tk", "ta", "tb"), into):
            st[k][:, :tok_cap] = buf
    walk = status < 0
    st["pos"] = starts.to(i64).clone()
    st["tp"] = tok0.to(i64).clone()
    st["total"] = tab[:, TAB_OUTBASE].to(i64).clone()
    st["mode"] = torch.where(walk, M_TOKENS, M_DONE)
    st["err"] = torch.where(walk, 0, status)
    lanes = torch.arange(B, device=dev)

    # the first pass follows the header without a bounds check, as the
    # JAX package's block loop runs it in the header's iteration
    sel = walk
    while True:
        s = lanes[sel]
        if s.numel() == 0:
            break
        plane = _dyn_plane(ext[s], st["pos"][s], end[s], pwin, tab[s],
                           lit_sym[s], dist_sym[s])
        block_pass(st, s, plane, tok_cap)
        sel = (st["mode"] == M_TOKENS) & in_bounds(st, end, 8 * M, tok_cap)
    return finish(st, end, tok_cap)


def tokenize_dyn_batch(rows: torch.Tensor, end_bits: torch.Tensor,
                       tab: torch.Tensor, starts: torch.Tensor,
                       status: torch.Tensor, tok0: torch.Tensor,
                       tok_cap: int, pwin: int, into=None):
    """Tokenize rows uint8[B, M] up to end_bits int32[B] under the tables
    tab int32[B, TAB_W], from starts int32[B], for the lanes whose status
    int32[B] is negative, after tok0 int32[B] earlier tokens.

    Returns (tk, ta, tb, ntok, out_total, end_pos, err), see
    ``kernels.tokenize``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, one block a lane, which writes the block's
    tokens into ``into`` in place and otherwise fills fresh buffers, zero
    outside the block's tokens."""
    if rows.device.type == "cpu":
        return tokenize_dyn_plain(rows, end_bits, tab, starts, status,
                                  tok0, tok_cap, pwin, into)
    for name, x, dt in (("rows", rows, torch.uint8),
                        ("end_bits", end_bits, torch.int32),
                        ("tab", tab, torch.int32),
                        ("starts", starts, torch.int32),
                        ("status", status, torch.int32),
                        ("tok0", tok0, torch.int32)):
        if x.dtype != dt:
            raise ValueError(f"tokenize_dyn_batch: {name} is {x.dtype}, "
                             f"expected {dt}")
    build.require_cuda("tokenize_dyn_batch", rows, end_bits, tab, starts,
                       status, tok0)
    B, M = rows.shape
    if tab.shape != (B, TAB_W):
        raise ValueError(f"tokenize_dyn_batch: tab {tuple(tab.shape)}")
    dev = rows.device
    if into is None:  # the kernel zeroes the slots it does not fill
        tk, ta, tb = (torch.empty(B, tok_cap, dtype=torch.int32, device=dev)
                      for _ in range(3))
    else:
        tk, ta, tb = into
        build.require_cuda("tokenize_dyn_batch", tk, ta, tb)
        if any(t.dtype != torch.int32 or t.shape != (B, tok_cap)
               for t in into):
            raise ValueError("tokenize_dyn_batch: into expects int32 "
                             "[B, tok_cap] token buffers")
    ntok, out_total, end_pos, err = (
        torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4)
    )
    if B == 0:
        return tk, ta, tb, ntok, out_total, end_pos, err
    code = build.library().tokenize_dyn_launch(
        rows.data_ptr(), end_bits.data_ptr(), tab.data_ptr(),
        starts.data_ptr(), status.data_ptr(), tok0.data_ptr(),
        tk.data_ptr(), ta.data_ptr(),
        tb.data_ptr(), ntok.data_ptr(), out_total.data_ptr(),
        end_pos.data_ptr(), err.data_ptr(), int(into is None), B, M,
        tok_cap, pwin, build.stream_handle(dev),
    )
    build.check(code, "tokenize_dyn")
    tokenize_dyn_batch.launches += 1
    return tk, ta, tb, ntok, out_total, end_pos, err


tokenize_dyn_batch.launches = 0


# ---------------------------------------------------------------------------
# The tile-parallel form: one lane, one block
# ---------------------------------------------------------------------------


def hier_shape(pw: int):
    """(tiles T, tiles per walk chunk, token capacity) of a pw-bit window,
    as the JAX kernel sizes them for tier 2: a tile whose chunk starts at
    or past the end bit is not walked, and the capacity is the token rows
    of its compaction, 128 tokens each."""
    T = pw // TILE
    if T % 128 or T & (T - 1) or T > 8192:
        raise ValueError(f"tokenize_dyn_hier: pw = {pw} must be 2^k * 8192, "
                         "at most 2^19")
    u = T // 128
    chunk = next(d * 128 for d in range(u, 0, -1) if u % d == 0 and d * 128 <= 640)
    rows = max(-(-min(HIER_WLK * T, pw // 8 + 64) // 128) + 2, 40)
    return T, chunk, rows * 128


def _hier_maps_plain(rows: torch.Tensor, end_bits: torch.Tensor,
                      tab: torch.Tensor, pw: int):
    """The candidate symbol (kind, adv, ta, tb) int64[pw] at every bit of
    the window rows[0, :pw / 8] (bytes past it read as zero) and the
    packed transfer maps int32[1, 16, T]: entry e of tile t is the phase
    in tile t + 1 that the chain from phase e reaches within 32 links, or
    STOP where it ends at a terminator."""
    T = pw // TILE
    dev = rows.device
    ext = torch.nn.functional.pad(rows[:1, : pw // 8].to(torch.int64),
                                  (0, pw // 8 + 16 - min(rows.shape[1], pw // 8)))
    lit_sym, dist_sym = rank_symbols(tab)
    kind, adv, ta, tb = (x[0] for x in _dyn_plane(
        ext, torch.zeros(1, dtype=torch.int64, device=dev),
        end_bits.to(torch.int64), pw, tab, lit_sym, dist_sym))
    q = torch.arange(pw, device=dev) % TILE
    m0 = torch.where((kind == K_EOB) | (kind == K_BAD), 255, q + adv).reshape(T, TILE)
    x = torch.arange(TILE, device=dev).expand(T, TILE)
    for _ in range(32):
        x = torch.where(x < TILE, torch.gather(m0, 1, x.clamp(max=TILE - 1)), x)
    phi = torch.where(x >= 2 * TILE, STOP, (x - TILE) & 0xFF)
    w = (phi.T.reshape(16, 4, T) << (8 * torch.arange(4, device=dev))[None, :, None]).sum(1)
    phiP = (((w + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)[None]
    return (kind, adv, ta, tb), phiP


def hier_maps_plain(rows: torch.Tensor, end_bits: torch.Tensor,
                    tab: torch.Tensor, pw: int):
    """Plain version of ``hier_maps``: ``_hier_maps_plain``'s fields packed
    as K1d packs them."""
    (kind, adv, ta, tb), phiP = _hier_maps_plain(rows, end_bits, tab, pw)
    plane = ((kind << 30) | (adv << 24) | (ta << 15)
             | torch.where(kind == K_MATCH, tb - 1, 0))
    return ((plane + (1 << 31)) & 0xFFFFFFFF) - (1 << 31), phiP


def hier_maps(rows: torch.Tensor, end_bits: torch.Tensor, tab: torch.Tensor,
              pw: int):
    """K1d of ``tokenize_dyn_hier``: (plane int32[pw], the candidate
    symbol's fields kind << 30 | adv << 24 | ta << 15 | dist - 1 at every
    bit of the window, and phiP int32[1, 16, pw / 64], the packed transfer
    maps of ``_hier_maps_plain``).  CPU tensors take the plain version,
    CUDA tensors the kernel; ``tokenize_dyn_hier`` counts the launch."""
    if rows.device.type == "cpu":
        plane, phiP = hier_maps_plain(rows, end_bits, tab, pw)
        return plane.to(torch.int32), phiP
    build.require_cuda("tokenize_dyn_hier", rows, end_bits, tab)
    dev = rows.device
    plane = torch.empty(pw, dtype=torch.int32, device=dev)
    phiP = torch.empty(1, 16, pw // TILE, dtype=torch.int32, device=dev)
    code = build.library().tokenize_hier_k1d_launch(
        rows.data_ptr(), min(rows.shape[1], pw // 8), end_bits.data_ptr(),
        tab.data_ptr(), plane.data_ptr(), phiP.data_ptr(), pw,
        build.stream_handle(dev))
    build.check(code, "tokenize_hier_k1d")
    return plane, phiP


def _hier_walk_plain(fields, ent: torch.Tensor, end: int, out_base: int,
                    pw: int):
    """Walk every tile from its entry phase ent int32[1, 1, T] for at most
    33 visits: (tk, ta, tb int32[1, tokcap], ntok, out_total, end_pos, err
    int32[1]) with the JAX kernel's rules."""
    kind, adv, tav, tbv = fields
    T, chunk, tokcap = hier_shape(pw)
    dev = kind.device
    t = torch.arange(T, device=dev)
    cur = torch.where(TILE * (t - t % chunk) < end, ent.reshape(T).to(torch.int64), -1)
    seen = []  # per visit: (token, kind, ta, tb, position, adv), each [T]
    for _ in range(HIER_WLK):
        inb = (cur >= 0) & (cur < TILE)
        p = TILE * t + cur.clamp(0, TILE - 1)
        k = torch.where(inb, kind[p], -1)
        seen.append((inb & ((k == K_LIT) | (k == K_MATCH)), k, tav[p], tbv[p], p, adv[p]))
        term = (k == K_EOB) | (k == K_BAD)
        cur = torch.where(inb, torch.where(term, 255, cur + adv[p]), cur)
    tok, k, ta, tb, p, a = (torch.stack(c, 1).reshape(-1) for c in zip(*seen))
    n = torch.where(tok, torch.where(k == K_LIT, 1, ta), 0)
    before = torch.cumsum(n, 0) - n + out_base
    too_far = bool((tok & (k == K_MATCH) & (tb > before)).any())
    ntok, total = int(tok.sum()), int(n.sum())
    bad = bool((k == K_BAD).any())
    eob = torch.where(k == K_EOB, (p << 6) | a, -1).max()
    eob = int(eob) if eob.numel() else -1
    if too_far:
        err = ERR_DIST
    elif ntok >= tokcap - 8:
        err = ERR_OVERFLOW
    elif bad:
        err = ERR_BAD_CODE
    else:
        err = ERR_OK if eob >= 0 else ERR_INPUT
    end_pos = (eob >> 6) + (eob & 63) if eob >= 0 else end
    if end <= 3:  # an empty lane
        err, end_pos = ERR_OK, 0
    i = tok.nonzero()[:tokcap, 0]
    out = [torch.zeros(1, tokcap, dtype=torch.int32, device=dev) for _ in range(3)]
    for o, v in zip(out, ((k == K_MATCH).to(torch.int64), ta, tb)):
        o[0, : i.numel()] = v[i].to(torch.int32)
    return (*out, *(torch.tensor([v], dtype=torch.int32, device=dev)
                    for v in (ntok, total, end_pos, err)))


def tokenize_dyn_hier_plain(rows: torch.Tensor, end_bits: torch.Tensor,
                            tab: torch.Tensor, starts: torch.Tensor, pw: int):
    """Plain version of ``tokenize_dyn_hier``: the candidate plane of
    ``_dyn_plane``, the maps by 32 steps of every chain, the entry phases
    by ``ent_from_phi_plain``'s composition, the walk vectorized over
    tiles."""
    fields, phiP = _hier_maps_plain(rows, end_bits, tab, pw)
    ent = ent_from_phi_plain(phiP, starts.reshape(()))
    return _hier_walk_plain(fields, ent, int(end_bits[0]),
                           int(tab[0, TAB_OUTBASE]), pw)


def tokenize_dyn_hier(rows: torch.Tensor, end_bits: torch.Tensor,
                      tab: torch.Tensor, starts: torch.Tensor, pw: int):
    """Tokenize the block of ONE lane, rows uint8[1, M] up to end_bits
    int32[1], under tab int32[1, TAB_W], from bit starts int32[1] (< 64),
    in a window of pw bit positions: (tk, ta, tb int32[1, tokcap], ntok,
    out_total, end_pos, err int32[1]), tokcap from ``hier_shape``.

    CPU tensors take the plain version; CUDA tensors launch the two
    kernels of ``csrc/tokenize_hier.cu`` with ``ent_from_phi`` between
    them; the second walks K3D_TILES tiles a block and writes into one
    zeroed allocation."""
    for name, x, dt, shape in (("rows", rows, torch.uint8, None),
                               ("end_bits", end_bits, torch.int32, (1,)),
                               ("tab", tab, torch.int32, (1, TAB_W)),
                               ("starts", starts, torch.int32, (1,))):
        if x.dtype != dt or (shape and tuple(x.shape) != shape):
            raise ValueError(f"tokenize_dyn_hier: {name} {x.dtype} "
                             f"{tuple(x.shape)}, expected {dt} {shape}")
    if rows.dim() != 2 or rows.shape[0] != 1:
        raise ValueError(f"tokenize_dyn_hier: rows {tuple(rows.shape)}, one lane")
    T, chunk, tokcap = hier_shape(pw)
    if rows.device.type == "cpu":
        return tokenize_dyn_hier_plain(rows, end_bits, tab, starts, pw)
    build.require_cuda("tokenize_dyn_hier", rows, end_bits, tab, starts)
    dev = rows.device
    plane, phiP = hier_maps(rows, end_bits, tab, pw)
    ent = ent_from_phi(phiP, starts.reshape(()))
    # one zeroed allocation: the token buffers (zero past the count), meta,
    # and K3d's scratch (control words, then a 64-bit status word a run of
    # K3D_TILES tiles)
    runs = T // K3D_TILES
    buf = torch.zeros(3 * tokcap + 8 + 8 + 2 * runs, dtype=torch.int32, device=dev)
    tk, ta, tb = (buf[i * tokcap : (i + 1) * tokcap].view(1, tokcap) for i in range(3))
    meta = buf[3 * tokcap : 3 * tokcap + 4]
    scratch = buf[3 * tokcap + 8 :]
    code = build.library().tokenize_hier_k3d_launch(
        plane.data_ptr(), ent.data_ptr(), end_bits.data_ptr(), tab.data_ptr(),
        tk.data_ptr(), ta.data_ptr(), tb.data_ptr(), meta.data_ptr(),
        scratch.data_ptr(), scratch.numel(), T, chunk, tokcap,
        build.stream_handle(dev))
    build.check(code, "tokenize_hier_k3d")
    tokenize_dyn_hier.launches += 1
    return (tk, ta, tb, *meta.split(1))


tokenize_dyn_hier.launches = 0
