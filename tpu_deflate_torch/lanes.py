"""DEFLATE lanes built by hand, for holding the kernels to their plain
versions where trouble is likely: dynamic blocks under code lengths of the
caller's choice (a 48-bit symbol, an incomplete code), and token lanes
whose matches reach before the start of their row.  ``chip_smoke.py`` and
the tests build their edge lanes here."""

from __future__ import annotations

import numpy as np

from tpu_deflate_torch.spec import tables as T


def bits_to_bytes(fields) -> bytes:
    """(value, nbits) fields, LSB first -> bytes."""
    acc = nb = 0
    out = bytearray()
    for v, n in fields:
        acc |= v << nb
        nb += n
        while nb >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nb -= 8
    if nb:
        out.append(acc & 0xFF)
    return bytes(out)


def canonical(lengths) -> dict:
    """{symbol: (code bit-reversed for LSB-first packing, length)}, RFC 1951
    3.2.2."""
    top = max(lengths)
    count = [0] * (top + 1)
    for n in lengths:
        count[n] += n > 0
    code, nxt = 0, [0] * (top + 1)
    for b in range(1, top + 1):
        code = (code + count[b - 1] * (b > 1)) << 1
        nxt[b] = code
    out = {}
    for s, n in enumerate(lengths):
        if n:
            out[s] = (int(f"{nxt[n]:0{n}b}"[::-1], 2), n)
            nxt[n] += 1
    return out


def hand_block(lit, dist, tokens) -> bytes:
    """A final dynamic block under the code lengths lit[286], dist[30]
    (each code length sent as a 4-bit code-length code): tokens
    ("lit", byte), ("match", length, distance), ("bits", value, width),
    then the end-of-block."""
    cl = canonical([4] * 16 + [0, 0, 0])  # code lengths 0..15, 4 bits each
    f = [(1, 1), (2, 2), (286 - 257, 5), (30 - 1, 5), (19 - 4, 4)]
    f += [(4 if s < 16 else 0, 3) for s in T.CODE_LENGTH_ORDER]
    f += [cl[n] for n in lit + dist]
    lc, dc = canonical(lit), canonical(dist)
    for kind, a, *b in tokens:
        if kind == "lit":
            f.append(lc[a])
        elif kind == "bits":
            f.append((a, b[0]))
        else:
            i = 28 if a == 258 else int(np.searchsorted(T.LENGTH_BASE, a, "right")) - 1
            j = int(np.searchsorted(T.DIST_BASE, b[0], "right")) - 1
            f += [lc[257 + i], (a - int(T.LENGTH_BASE[i]), int(T.LENGTH_EXTRA_BITS[i])),
                  dc[j], (b[0] - int(T.DIST_BASE[j]), int(T.DIST_EXTRA_BITS[j]))]
    f.append(lc[256])
    return bits_to_bytes(f)


def wide_block() -> bytes:
    """A block whose widest symbol is 48 bits: a 15-bit code for length
    symbol 284 (5 extra bits) and for distance symbols 28 and 29 (13 extra
    bits).  A literal and 96 matches of 258 at distance 1 first make 24769
    bytes of output for them to reach into; then every distance code once,
    its extra bits drawn from a fixed seed."""
    lit = [0] * 286
    lit[97], lit[285] = 1, 2
    for k, s in enumerate(range(98, 109)):
        lit[s] = 3 + k
    lit[256], lit[109], lit[284] = 14, 15, 15
    dist = [0] * 30
    for s in range(14):
        dist[s] = s + 1
    dist[28] = dist[29] = 15
    toks = [("lit", 97)] + [("match", 258, 1)] * 96
    toks += [("lit", s) for s in range(98, 110)]
    toks += [("match", 227 + 17, 24577 + 150),  # 15 + 5 + 15 + 13 bits
             ("match", 230, 16385 + 4000)]
    rng = np.random.default_rng(4)
    for s in range(14):
        d = int(T.DIST_BASE[s]) + int(rng.integers(0, 1 << int(T.DIST_EXTRA_BITS[s])))
        toks += [("match", 258, d), ("lit", 97 + s % 12)]
    return hand_block(lit, dist, toks)


def bad_code_block() -> bytes:
    """A block under an incomplete literal/length code (codes 0, 10, 110,
    1110): after a few literals, the unused code 1111."""
    lit = [0] * 286
    lit[97], lit[98], lit[99], lit[256] = 1, 2, 3, 4
    dist = [0] * 30
    dist[0] = 1
    return hand_block(lit, dist, [("lit", 97), ("lit", 98), ("lit", 99),
                                  ("lit", 97), ("bits", 15, 4), ("lit", 97)])


# literal 'A', literal 'B', a match of length 4 at distance 5, literal 'C':
# its bytes, the match's first three from before the row taking byte 0's value
FAR_LANE = [(0, 65, 0), (0, 66, 0), (1, 4, 5), (0, 67, 0)]
FAR_BYTES = [65, 66, 65, 65, 65, 65, 67]


def far_token_lanes(seed: int, B: int = 4, K: int = 96):
    """(tk, ta, tb, tp) int32 numpy: FAR_LANE, then seeded lanes of
    literals and matches (distances to 256, lengths 3 to 258) where about a
    third of the matches reach before the row, overlapping runs among them,
    and a last lane that starts with a match."""
    rng = np.random.default_rng(seed)
    tk, ta, tb = (np.zeros((B, K), np.int32) for _ in range(3))
    tp = np.zeros(B, np.int32)
    for b in range(B):
        if b == 0:
            toks = FAR_LANE
        else:
            toks, pos = [], 0
            if b == B - 1:  # the row's first byte is a match byte
                toks.append((1, 5, 3))
                pos = 5
            while len(toks) < K - 2:
                if rng.random() < 0.4:
                    toks.append((0, int(rng.integers(0, 256)), 0))
                    pos += 1
                    continue
                n = int(rng.integers(3, 259))
                far = rng.random() < 0.35
                d = int(rng.integers(pos + 1, pos + 257)) if far else int(
                    rng.integers(1, pos + 1)) if pos else 1
                toks.append((1, n, min(d, 256)))
                pos += n
        tp[b] = len(toks)
        for k, (kind, a, d) in enumerate(toks):
            tk[b, k], ta[b, k], tb[b, k] = kind, a, d
    return tk, ta, tb, tp


def expand2_edge_lanes(seed: int, tile: int):
    """Token lanes for a tiled expansion with tiles of ``tile`` bytes:
    (names, tk, ta, tb, tp int32 numpy, cut int32 numpy, out_cap).  A lane
    whose ``cut`` is 0 or more takes that total in place of its tokens'
    sum; out_cap is not a multiple of the tile.  The lanes: a match that
    crosses a tile boundary; a tile whose every byte has its root in the
    tile before; a source exactly 32768 back and one before the row; a
    match of distance 0, then matches that copy its zeros; no token at all
    (tp = 0, total 5000); a total cut inside a tile; a distance-1 run over
    the whole row."""
    rng = np.random.default_rng(seed)
    out_cap = max(3 * tile, 34816) + 1000

    def lits(n):
        return [(0, int(v), 0) for v in rng.integers(0, 256, n)]

    lanes = {
        "crosses_tile": lits(tile - 100) + [(1, 258, 300)] + lits(50)
        + [(1, 258, tile // 2)],
        "tile_all_earlier": lits(tile) + [(1, 258, tile)] * (tile // 258 + 1),
        "far_32768": lits(32768 + 10) + [(1, 100, 32768), (1, 20, 40000)]
        + lits(3),
        "distance_0": lits(500) + [(1, 50, 0)] + [(1, 258, 60)] * 10 + lits(5),
        "tp_0": [],
        "total_cut": lits(2 * tile) + [(1, 258, 7)] * (tile // 258),
        "d1_run": [(0, 65, 0)] + [(1, 258, 1)] * ((out_cap - 1) // 258),
    }
    cuts = {"tp_0": 5000, "total_cut": 2 * tile + 77}
    names = list(lanes)
    K = max(len(t) for t in lanes.values())
    tk, ta, tb = (np.zeros((len(names), K), np.int32) for _ in range(3))
    tp = np.array([len(lanes[n]) for n in names], np.int32)
    cut = np.array([cuts.get(n, -1) for n in names], np.int32)
    for b, n in enumerate(names):
        if lanes[n]:
            tk[b, : tp[b]], ta[b, : tp[b]], tb[b, : tp[b]] = np.array(lanes[n]).T
    return names, tk, ta, tb, tp, cut, out_cap


def ent_edge_maps(T: int, kind: str, seed: int):
    """Packed transfer maps int32[1, 16, T] (entries 4g..4g+3 of tile t in
    the bytes of word [g, t]) for the edges of ``ent_from_phi``: "stops_first"
    (every entry of tile 0 is STOP = 191), "stops_last" (only tile T - 1's),
    "high" (a few entries of 64..190 and of 192..255 among entries in
    [0, 64)); otherwise entries in [0, 64) alone."""
    rng = np.random.default_rng(seed)
    phi = rng.integers(0, 64, (64, T))  # [entry, tile]
    if kind == "stops_first":
        phi[:, 0] = 191
    elif kind == "stops_last":
        phi[:, -1] = 191
    elif kind == "high":
        out = rng.random((64, T)) < max(0.0005, 4 / (64 * T))
        high = np.where(rng.random((64, T)) < 0.5, rng.integers(64, 191, (64, T)),
                        rng.integers(192, 256, (64, T)))
        phi = np.where(out, high, phi)
        phi[0, -1], phi[1, -1] = 100, 200
    packed = phi[0::4] | (phi[1::4] << 8) | (phi[2::4] << 16) | (phi[3::4] << 24)
    return packed.astype(np.uint32).view(np.int32)[None]


# ---------------------------------------------------------------------------
# the tile-parallel tokenizer's and the code-length chase's edges
# ---------------------------------------------------------------------------

# literal/length codes of at least 2 bits (the tile-parallel tokenizer's
# domain): 'a', 'b', 'c' in 2 bits, the end-of-block in 3, lengths 3 and 4
# in 4; distances 1 and 3073..8192 in 2 bits
EDGE_LIT = [0] * 286
EDGE_LIT[97] = EDGE_LIT[98] = EDGE_LIT[99] = 2
EDGE_LIT[256], EDGE_LIT[257], EDGE_LIT[258] = 3, 4, 4
EDGE_DIST = [0] * 30
EDGE_DIST[0] = EDGE_DIST[23] = EDGE_DIST[24] = EDGE_DIST[25] = 2
EDGE_OUT_BASE = 37  # output bytes of the lane before the far lanes' block
# the first symbol's bit in hand_block: the block header, 19 code-length
# codes and 316 code lengths of 4 bits
EDGE_FIRST_BIT = 3 + 14 + 3 * 19 + 4 * 316


def _edge_block(lit, special, at_tile: int, after: int = 40):
    """A block under the code lengths lit (EDGE_LIT's or another with the
    same 2-bit literals and 4-bit lengths) whose tokens are seeded
    literals and distance-1 matches (six in ten, 6 bits each) up to the
    64-bit tile at_tile of the window that starts at the first symbol's
    byte, then special(bytes of output so far) (a list of tokens) starting
    in that tile, then ``after`` literals.  Returns (stream, bytes of
    output before special)."""
    rng = np.random.default_rng(at_tile)
    bit = EDGE_FIRST_BIT & 7  # the window starts at the first symbol's byte
    lo = 64 * at_tile
    toks, out = [], 0
    lengths = [n for n in (3, 4) if lit[257 + n - 3]]  # symbols 257, 258
    while bit + 6 <= lo:
        if out and rng.random() < 0.6:
            n = int(rng.choice(lengths))
            toks.append(("match", n, 1))
            bit, out = bit + 6, out + n
        else:
            toks.append(("lit", int(rng.integers(97, 100))))
            bit, out = bit + 2, out + 1
    while bit < lo:
        toks.append(("lit", 97))
        bit, out = bit + 2, out + 1
    assert lo <= bit < lo + 64
    toks += special(out)
    toks += [("lit", int(v)) for v in rng.integers(97, 100, after)]
    return hand_block(lit, EDGE_DIST, toks), out


def hier_edge_streams(run_tiles: int) -> dict:
    """Blocks for the edges of the tile-parallel tokenizer's walk, whose
    blocks walk runs of ``run_tiles`` tiles: {name: (stream, end bit
    relative to the window or None for the stream's own, TAB_OUTBASE)}.

    eob_last_tile: the end-of-block in the last tile of the second run.
    end_on_chunk: a block longer than 32768 bits cut at bit 32768 of the
      window, a boundary of the walk's 32768-bit chunks.
    bad_code_second_run: an unused code (1111 of an incomplete code) in
      the second run.
    far_second_run, reach_second_run: a match whose distance is one more
      than, and exactly, the output before it (EDGE_OUT_BASE bytes of
      earlier blocks included), in the second run, past its first tile.
    empty_end0, empty_end3: end bits 0 and 3."""
    second = run_tiles + 37
    eob, _ = _edge_block(EDGE_LIT, lambda out: [], 2 * run_tiles - 1,
                         after=0)
    long_, _ = _edge_block(EDGE_LIT, lambda out: [], 520, after=200)
    incomplete = list(EDGE_LIT)
    incomplete[258] = 0  # 3 x 2 bits, 3 bits, 4 bits: 15/16, 1111 unused
    bad, _ = _edge_block(incomplete, lambda out: [("bits", 15, 4)],
                         second)

    def far(extra):
        return lambda out: [("match", 3, EDGE_OUT_BASE + out + extra)]

    far1, out1 = _edge_block(EDGE_LIT, far(1), second)
    far0, out0 = _edge_block(EDGE_LIT, far(0), second)
    assert 3073 <= EDGE_OUT_BASE + out0 and EDGE_OUT_BASE + out1 + 1 <= 8192
    return {
        "eob_last_tile": (eob, None, 0),
        "end_on_chunk": (long_, 32768, 0),
        "bad_code_second_run": (bad, None, 0),
        "far_second_run": (far1, None, EDGE_OUT_BASE),
        "reach_second_run": (far0, None, EDGE_OUT_BASE),
        "empty_end0": (eob, 0, 0),
        "empty_end3": (eob, 3, 0),
    }


def hier_lane(stream: bytes, pw: int, end=None, out_base: int = 0,
              min_len: int = 2):
    """One block's lane as the device-paced decode hands it to
    ``tokenize_dyn_hier``: (rows uint8[1, pw / 8], end_bits, tab, starts
    int32 numpy), the window re-based at the first symbol's byte, the
    tables from the port's header parse with TAB_OUTBASE = out_base, the
    end bit ``end`` (relative to the window) or the stream's own.  The
    shortest literal/length code must be at least ``min_len`` bits (2,
    the device-paced decode's domain, unless the caller says less)."""
    import torch

    from tpu_deflate_torch.kernels.tokenize_dyn import TAB_OUTBASE
    from tpu_deflate_torch.ops.decode import dyn_header_params_batch

    s = np.frombuffer(stream, np.uint8)
    rows = np.zeros((1, len(s) + pw // 8), np.uint8)
    rows[0, : len(s)] = s
    prep = dyn_header_params_batch(torch.from_numpy(rows),
                                   torch.tensor([8 * len(s)], dtype=torch.int32))
    start = int(prep["start"][0])
    assert bool(prep["ok"][0]) and int(prep["min_len"][0]) >= min_len
    tab = prep["tab"].numpy().astype(np.int32)
    tab[0, TAB_OUTBASE] = out_base
    base2 = start >> 3
    end_rel = 8 * len(s) - 8 * base2 if end is None else end
    return (rows[:, base2 : base2 + pw // 8].copy(), np.array([end_rel], np.int32),
            tab, np.array([start & 7], np.int32))


def k1d_edge_lanes(pw: int) -> dict:
    """Lanes (as ``hier_lane`` gives them) for the edges of the
    tile-parallel tokenizer's candidates and maps (K1d): {name: lane}.

    one_bit_code: a 1-bit literal code and runs of 300 of its literal, so
      chains run 32 links without leaving their tile.
    eob_phase0, eob_phase63: the end-of-block at phase 0 of a tile, and at
      phase 63 (after a match of 17 bits, distance 4097).
    wide: ``wide_block``'s 48-bit symbols, some crossing into the next
      tile (its literal code also has a 1-bit code).
    end_mid_tile, end_on_block: a block longer than the window cut at bit
      37 of a tile, and on a boundary of K1d's blocks (K1D_BITS)."""
    from tpu_deflate_torch.kernels.tokenize_dyn import K1D_BITS

    lit = [0] * 286
    lit[97], lit[256], lit[98], lit[257] = 1, 2, 3, 3
    dist = [0] * 30
    dist[0] = 1
    toks = ([("lit", 98)] + [("lit", 97)] * 300 + [("match", 3, 1)] * 20
            + [("lit", 98), ("lit", 97)] * 40 + [("lit", 97)] * 300)
    one_bit = hand_block(lit, dist, toks)
    eob0, _ = _edge_block(EDGE_LIT, lambda out: [], 7, after=0)

    def at_63(out):
        assert out >= 4097  # distance 4097 has 11 extra bits: 17 bits in all
        return [("match", 3, 4097)] + [("lit", 97)] * 55

    eob63, _ = _edge_block(EDGE_LIT, at_63, 150, after=0)
    long_, _ = _edge_block(EDGE_LIT, lambda out: [], 520, after=200)
    return {
        "one_bit_code": hier_lane(one_bit, pw, min_len=1),
        "eob_phase0": hier_lane(eob0, pw),
        "eob_phase63": hier_lane(eob63, pw),
        "wide": hier_lane(wide_block(), pw, min_len=1),
        "end_mid_tile": hier_lane(long_, pw, 64 * 300 + 37),
        "end_on_block": hier_lane(long_, pw, 5 * K1D_BITS),
    }


def visit_edge_cases(seed: int) -> dict:
    """(advT, termT int32[64, T], p0) for the edges of the code-length
    chase, in its (in-tile position, tile) layout: {name: case}.

    p0_63: the orbit starts at the first tile's last position.
    term_at_p0: a terminator at p0, the orbit is p0 alone.
    to_last: no terminator, jumps of 1 over the last 20 positions, so
      the orbit reaches position 64 T - 1.
    T256: 64 x 256 positions, the widest the chase takes.
    jumps_to_64: jumps of 1..64, so chains leave a tile from any phase
      and land anywhere in the next."""
    rng = np.random.default_rng(seed)

    def case(T, hi=15, p_term=0.002):
        adv = rng.integers(1, hi, 64 * T)
        term = rng.random(64 * T) < p_term
        return adv, term

    out = {}
    adv, term = case(128)
    out["p0_63"] = (adv, term, 63)
    adv, term = case(128)
    term[5] = True
    out["term_at_p0"] = (adv, term, 5)
    adv, term = case(128, p_term=0.0)
    adv[-20:] = 1
    out["to_last"] = (adv, term, 0)
    out["T256"] = (*case(256), 3)
    out["jumps_to_64"] = (*case(128, hi=65, p_term=0.0005), 0)
    return {name: (a.reshape(-1, 64).T.astype(np.int32).copy(),
                   t.reshape(-1, 64).T.astype(np.int32).copy(), p0)
            for name, (a, t, p0) in out.items()}


# ---------------------------------------------------------------------------
# resolve_roots' edges
# ---------------------------------------------------------------------------


def _chains(order, last):
    """Parents int64[N] of chains through the positions ``order`` (a
    permutation of the row): each position's parent is the next one in
    order, and a position where ``last`` is set ends its chain, a root."""
    parent = np.arange(len(order))
    parent[order] = np.where(last, order, np.roll(order, -1))
    return parent


def resolve_edge_forests(tile: int, seed: int) -> dict:
    """Forests for the edges of a resolve_roots that resolves tiles of
    ``tile`` positions and chases chains across them: {name: (parent,
    val int32 numpy [B, N])}.

    forward: chains through a seeded permutation of the row, cut into
      chains of 1 to 4 tiles' length, so parents lie after and before
      their positions, near and far.
    zigzag: one chain over 16 tiles and 5 positions, 0, N - 1, 1, N - 2,
      ...: every link crosses tiles, alternately forward and backward.
    rows_b3: three rows of 2.5 tiles and 3 positions (no tile multiple):
      parents up to the row's length back, 4 in 5 of them; a distance-1
      run; a run whose parents lie one after (the root is the last).
    n1: two rows of one position."""
    rng = np.random.default_rng(seed)
    out = {}
    N = 5 * tile + 37
    last = np.zeros(N, bool)
    cuts = np.cumsum(rng.integers(1, 4 * tile, N))
    last[cuts[cuts < N] - 1] = True
    last[-1] = True
    out["forward"] = _chains(rng.permutation(N), last)[None]
    N = 16 * tile + 5
    order = np.empty(N, np.int64)
    order[0::2] = np.arange((N + 1) // 2)
    order[1::2] = N - 1 - np.arange(N // 2)
    out["zigzag"] = _chains(order, np.arange(N) == N - 1)[None]
    N = 2 * tile + tile // 2 + 3
    at = np.arange(N)
    back = rng.integers(1, N, N)
    far = np.where(rng.random(N) < 0.8, np.maximum(at - back, 0), at)
    out["rows_b3"] = np.stack([far, np.maximum(at - 1, 0), np.minimum(at + 1, N - 1)])
    out["n1"] = np.zeros((2, 1), np.int64)
    return {name: (p.astype(np.int32),
                   rng.integers(0, 256, p.shape).astype(np.int32))
            for name, p in out.items()}


# --- token starts for the dynamic trees (csrc/dyntrees.cu) ----------------


def tree_lane(tokens, n_extra: int = 0, seed: int = 0):
    """(start bool[N], litlen_sym, dsym int64[N]) of a lane holding tokens
    (literal/length symbol, distance symbol) at every other position; the
    positions between them and n_extra more at the end start no token and
    hold seeded garbage symbols, which the count must skip."""
    rng = np.random.default_rng(seed)
    tokens = np.asarray(tokens, np.int64).reshape(-1, 2)
    N = 2 * len(tokens) + n_extra
    start = np.zeros(N, bool)
    lsym = rng.integers(0, 286, N)
    dsym = rng.integers(0, 30, N)
    start[: 2 * len(tokens) : 2] = True
    lsym[: 2 * len(tokens) : 2] = tokens[:, 0]
    dsym[: 2 * len(tokens) : 2] = tokens[:, 1]
    return start, lsym, dsym


def tree_tokens(lf, df, seed: int = 0):
    """Tokens int64[T, 2] with literal/length counts lf[:286] and the
    distance counts df spread over the length codes (>= 257), in seeded
    order."""
    rng = np.random.default_rng(seed)
    lits = np.repeat(np.arange(286), lf)
    matches = lits >= 257
    if matches.sum() != np.sum(df):
        raise ValueError("tree_tokens: the distance counts are not the matches'")
    d = np.zeros(len(lits), np.int64)
    d[matches] = rng.permutation(np.repeat(np.arange(30), df))
    order = rng.permutation(len(lits))
    return np.stack([lits[order], d[order]], 1)


def over_15_counts():
    """(lf, df): every literal/length symbol used, 2^18 tokens in all with
    the end-of-block: 12 distinct powers of two, 200 counts of 16 (length
    14), 24 of 2 and 50 of 1 (a design solved for).  The ceil rule gives
    each count its exact share but clips the 74 rare ones from 17 and 18
    bits to 15, which oversubscribes the code by 63 units of 2^-15; the
    repair frees one a round from the symbols of length 14 and stops at 48
    rounds, so the lengths stay oversubscribed and the lane keeps static
    trees.  (Fibonacci counts would not do: their shares are no powers of
    two, and the ceil rule leaves each well under its share.)"""
    syms = [s for s in range(286) if s != 256]
    big = [1 << k for k in range(17, -1, -1) if 258846 >> k & 1]
    lf = np.zeros(286, np.int64)
    lf[syms] = big + [16] * 200 + [2] * 24 + [1] * 49
    df = np.full(30, lf[257:].sum() // 30)
    df[0] += lf[257:].sum() - df.sum()
    return lf, df


def cl_clipped_counts():
    """(lf, df): counts 2^(15 - L) of the lengths L, 8 and 9 alternating over
    the 256 literals, 3 .. 15 over the length codes 257 .. 269 and 15 for
    the end-of-block, a complete code of 2^15 tokens, which the rule keeps
    as it is; every match at distance code 29.  The 316 lengths run-length
    encode to 273 ops, 128 each of 8 and 9, so the code-length tree's ceil
    rule asks 9 bits of its rarest symbols and clips them to 7."""
    L = np.zeros(286, np.int64)
    L[:256] = 8 + np.arange(256) % 2
    L[257:270] = np.arange(3, 16)
    lf = np.where(L > 0, 1 << (15 - L), 0)
    df = np.zeros(30, np.int64)
    df[29] = lf[257:].sum()
    return lf, df


# 61 literals from a seeded search: their dynamic header and tokens take
# exactly the static trees' bits, so the lane keeps static trees
TIE_LITERALS = [4, 67, 171, 171, 4, 202, 253, 143, 190, 46, 200, 143, 223, 107, 200,
                95, 223, 239, 202, 4, 188, 2, 89, 4, 89, 46, 4, 200, 133, 171, 200, 95,
                108, 189, 200, 133, 200, 189, 200, 4, 200, 253, 200, 223, 253, 200, 4,
                202, 202, 171, 253, 4, 89, 133, 171, 39, 107, 202, 202, 189, 95]

TREE_EDGE_LANES = ("empty", "one_literal", "literals_only", "over_15_bits",
                   "cl_clipped", "static_tie")


def tree_edge_lane(name: str):
    """The hand-built lane ``name`` of TREE_EDGE_LANES: no token; one
    literal; 3000 seeded letters (no match: distance code 0 forced); the
    repair's 48 rounds run out (``over_15_counts``); the code-length tree
    clipped (``cl_clipped_counts``); dynamic and static trees alike in
    bits (``TIE_LITERALS``)."""
    if name == "empty":
        return tree_lane([], n_extra=64)
    if name == "one_literal":
        return tree_lane([(65, 0)], n_extra=5)
    if name == "literals_only":
        letters = np.random.default_rng(1951).integers(97, 123, 3000)
        return tree_lane([(int(b), 0) for b in letters], seed=1)
    if name == "over_15_bits":
        return tree_lane(tree_tokens(*over_15_counts()), seed=2)
    if name == "cl_clipped":
        return tree_lane(tree_tokens(*cl_clipped_counts()), seed=3)
    if name == "static_tie":
        return tree_lane([(s, 0) for s in TIE_LITERALS], seed=4)
    raise ValueError(f"tree_edge_lane: no lane {name!r}")
