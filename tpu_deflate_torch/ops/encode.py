"""Block encoder for chunk lanes, static or dynamic Huffman trees, any
window up to 32768.

Four stages per lane, all lanes at once:

  1+2. match search and extension.  Windows <= 256 take the ``match2``
       kernel: every position's nearest 3-byte match, extended.  Larger
       windows take a far matcher built on stable sorts: the most recent
       occurrences of each position's 3-byte key (a chain of them) and of
       hashed longer keys are candidates, each probed, the winner
       extended (``far_matcher="exact"``: the ``farmatch`` kernel on the
       card) or stitched from runs of positions that verified 8 bytes at
       one distance (``"fast"``).
       With ``lazy`` a match is dropped where the next position holds a
       strictly longer one;
  3.   greedy parse: the token starts are the positions reachable from 0
       under next[i] = i + max(length[i], 1) (``ops.header.chase_reach``);
  4.   emissions: each token's code plus extra bits as values and bit
       widths, bit offsets by prefix sum, then the bytes by a scatter-add
       of 16-bit channels (the ``monotone`` kernel).  With dynamic_encode
       each lane also builds length-limited trees from its symbol counts
       and keeps them where header and tokens take fewer bits than the
       static trees (the ``dyntrees`` kernel on the card).

Each lane is one block; a non-final lane ends byte-aligned with an
empty stored block, so lanes concatenate bytewise into one stream, and a
lane whose stored encoding is shorter is emitted stored instead.  Output
is byte-identical to ``tpu_deflate.ops.encode.encode_blocks_batch``, and
the single-lane ``encode_block_bits`` / ``encode_block`` (the sharding
layer's dry run) to their JAX namesakes.
"""

from __future__ import annotations

import torch

from tpu_deflate_torch.config import DeflateConfig
from tpu_deflate_torch.kernels.dyntrees import dyn_trees_batch
from tpu_deflate_torch.kernels.farmatch import far_match_batch
from tpu_deflate_torch.kernels.match2 import MAX_WINDOW, match_bitplane_batch
from tpu_deflate_torch.kernels.monotone import mono_scatter_add
from tpu_deflate_torch.ops.header import chase_reach
from tpu_deflate_torch.spec import tables as T
from tpu_deflate_torch.utils.profiling import count, span

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


# --- far matchers (window > 256): [B, N] lanes, int64 throughout ---------


def _ahead(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[:, i + k], zero past the lane's end."""
    if k == 0:
        return x
    return torch.cat([x[:, k:], x.new_zeros(x.shape[0], min(k, x.shape[1]))], 1)


def _prev_occurrence(key: torch.Tensor) -> torch.Tensor:
    """prev[b, i] = the largest j < i with key[b, j] == key[b, i], else -1.
    A stable sort places every position right after the previous
    occurrence of its key."""
    sk, order = torch.sort(key, dim=1, stable=True)
    prev_pos = torch.nn.functional.pad(order[:, :-1], (1, 0), value=-1)
    same = torch.nn.functional.pad(sk[:, 1:] == sk[:, :-1], (1, 0))
    cand = torch.where(same, prev_pos, -1)
    return torch.full_like(key, -1).scatter(1, order, cand)


_HASH_MUL = 0x9E3779B1


def _key_hash(b: torch.Tensor, n: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Multiplicative hash of b[i .. i + nbytes - 1] in uint32 arithmetic,
    kept to its low 31 bits; -(i + 2) where the key crosses n, so those
    never match."""
    idx = torch.arange(b.shape[1], device=b.device)
    lo, hi = _HASH_MUL & 0xFFFF, _HASH_MUL >> 16
    acc = torch.zeros_like(b)
    for k in range(nbytes):
        # acc * _HASH_MUL mod 2^32 from two products below 2^48
        acc = acc * lo + (((acc * hi) & 0xFFFF) << 16) + _ahead(b, k)
        acc = acc & 0xFFFFFFFF
    acc = (acc ^ (acc >> 15)) & 0x7FFFFFFF
    return torch.where(idx + nbytes <= n, acc, -(idx + 2))


def _words(b: torch.Tensor) -> torch.Tensor:
    """The 4 bytes at each position packed little-endian, zero past the
    lane's end."""
    return b | (_ahead(b, 1) << 8) | (_ahead(b, 2) << 16) | (_ahead(b, 3) << 24)


def _extend_words(b, b4, dist, active, n, start: int, max_match: int):
    """Match lengths from ``start`` on at distances dist for the active
    positions (garbage elsewhere): 4 bytes a step by word compares, then
    up to 3 single bytes, bounded by max_match and n."""
    N = b.shape[1]
    idx = torch.arange(N, device=b.device)
    b4pad = torch.nn.functional.pad(b4, (0, max_match + 8))
    L = torch.full_like(b, start)
    al = active
    for k in range(start, max_match - 3, 4):
        # a position still alive at this step has L = k, so the target
        # side is a fixed shift
        src = (idx - dist + k).clamp(0, N - 1)
        al = al & (idx + k + 4 <= n) & (torch.gather(b4, 1, src) == b4pad[:, k : k + N])
        L = torch.where(al, L + 4, L)
    al = active
    for _ in range(3):
        src = (idx - dist + L).clamp(0, N - 1)
        tgt = (idx + L).clamp(0, N - 1)
        al = (al & (L < max_match) & (idx + L < n)
              & (torch.gather(b, 1, src) == torch.gather(b, 1, tgt)))
        L = torch.where(al, L + 1, L)
    return L


def _chain(key3: torch.Tensor, depth: int) -> list:
    """The ``depth`` most recent previous occurrences of each position's
    3-byte key, nearest first (-1 where there are fewer)."""
    N = key3.shape[1]
    prev3 = _prev_occurrence(key3)
    cands, c = [], prev3
    for _ in range(depth):
        cands.append(c)
        c = torch.where(c >= 0, torch.gather(prev3, 1, c.clamp(0, N - 1)), -1)
    return cands


def _match_candidates_multi(b, key3, n, window: int, max_match: int, depth: int = 4):
    """``far_matcher="exact"``: candidates are the ``depth`` most recent
    occurrences of the exact 3-byte key and the most recent ones of hashed
    6- and 10-byte keys; each is probed to 16 bytes, nearer distances
    winning ties, and the winner is extended to max_match.  Returns
    (dist, length) int64[B, N]."""
    N = b.shape[1]
    idx = torch.arange(N, device=b.device)
    probe = min(16, max_match)
    cands = _chain(key3, depth)
    cands += [_prev_occurrence(_key_hash(b, n, 6)),
              _prev_occurrence(_key_hash(b, n, 10))]
    b4 = _words(b)
    best_len = torch.zeros_like(b)
    best_dist = torch.zeros_like(b)
    for c in cands:
        d = idx - c
        # the exact 3-byte seed through the key itself: hashed keys may
        # collide, and key3's sentinels past n are unique
        valid = ((c >= 0) & (d >= 1) & (d <= window)
                 & (torch.gather(key3, 1, c.clamp(0, N - 1)) == key3))
        ln = torch.where(valid, _extend_words(b, b4, d, valid, n, 3, probe), 0)
        better = (ln > best_len) | ((ln == best_len) & (ln > 0) & (d < best_dist))
        best_len = torch.where(better, ln, best_len)
        best_dist = torch.where(better, d, best_dist)
    if max_match > probe:  # the winner alone extends past the probe
        at_cap = best_len == probe
        ext = _extend_words(b, b4, best_dist, at_cap, n, probe, max_match)
        best_len = torch.where(at_cap, ext, best_len)
    return best_dist, torch.minimum(best_len, (n - idx).clamp_min(0))


def _match_candidates_fast(b, key3, n, window: int, max_match: int, depth: int = 2):
    """``far_matcher="fast"``: candidates are the ``depth`` most recent
    occurrences of the 3-byte key and the most recent ones of hashed 7-
    and 12-byte keys, each probed to 8 bytes by two word compares; three
    sweeps then try the distances that the positions 1, 2 and 1 before
    verified to 8 bytes.  A run of positions i..i+k that all verified 8
    bytes at one distance is one match of length k + 8 at i (capped at
    max_match), so no byte loop extends past 8.  Returns (dist, length)
    int64[B, N]."""
    N = b.shape[1]
    idx = torch.arange(N, device=b.device)
    cands = _chain(key3, depth)
    cands += [_prev_occurrence(_key_hash(b, n, 7)),
              _prev_occurrence(_key_hash(b, n, 12))]
    b4 = _words(b)
    b4n = _ahead(b4, 4)
    lim = idx.clamp(max=window)

    def consider(best_len, best_dist, d, extra_valid, prefer_tie=False):
        cc = (idx - d).clamp(0, N - 1)
        valid = ((d >= 1) & (d <= lim) & (idx + 3 <= n) & extra_valid
                 & (torch.gather(key3, 1, cc) == key3))
        cw1 = torch.gather(b4n, 1, cc)
        m4 = valid & (torch.gather(b4, 1, cc) == b4)
        ok8 = m4 & (cw1 == b4n)
        ln = torch.where(m4, 4, torch.where(valid, 3, 0))
        for kk in range(3):  # bytes 4..6 one by one from the second word
            same = ((cw1 >> (8 * kk)) & 0xFF) == ((b4n >> (8 * kk)) & 0xFF)
            ln = torch.where(m4 & ~ok8 & (ln == 4 + kk) & same, ln + 1, ln)
        ln = torch.where(ok8, 8, ln)
        tie = True if prefer_tie else d < best_dist
        better = (ln > best_len) | ((ln == best_len) & (ln > 0) & tie)
        return torch.where(better, ln, best_len), torch.where(better, d, best_dist)

    best_len = torch.zeros_like(b)
    best_dist = torch.zeros_like(b)
    for c in cands:
        best_len, best_dist = consider(best_len, best_dist, idx - c, c >= 0)
    # a long repeat's 3-byte chain seldom picks one occurrence at every
    # position; adopting the distance a position 1 or 2 before verified
    # joins the pieces of its diagonal run (run continuity beats a nearer
    # distance)
    for shift in (1, 2, 1):
        d_prev = torch.nn.functional.pad(best_dist[:, :-shift], (shift, 0))
        l_prev = torch.nn.functional.pad(best_len[:, :-shift], (shift, 0))
        best_len, best_dist = consider(
            best_len, best_dist, d_prev, (l_prev >= 8) & (d_prev != best_dist),
            prefer_tie=True)
    # a run's end by a reversed running minimum of the positions where a
    # run of 8-byte matches at one distance breaks
    at8 = best_len == 8
    nxt_same = at8 & torch.nn.functional.pad(
        at8[:, 1:] & (best_dist[:, 1:] == best_dist[:, :-1]), (0, 1))
    brk = torch.where(at8 & ~nxt_same, idx, N)
    run_end = torch.cummin(brk.flip(1), dim=1).values.flip(1)
    best_len = torch.where(at8, (run_end - idx + 8).clamp(max=max_match), best_len)
    return best_dist, torch.minimum(best_len, (n - idx).clamp_min(0))


def _key3(b: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The 3 bytes at each position as one key; a 3-byte window that
    crosses n gets a key of its own, (1 << 24) + i, so it never matches."""
    idx = torch.arange(b.shape[1], device=b.device)
    key3 = b | (_ahead(b, 1) << 8) | (_ahead(b, 2) << 16)
    return torch.where(idx + 3 <= n, key3, (1 << 24) + idx)


def _far_match_plain(data: torch.Tensor, n: torch.Tensor, window: int,
                     max_match: int, far_matcher: str = "exact"):
    """The far matchers' torch glue on lanes data uint8[B, N] of lengths
    n int32[B]: (dist, length) int64[B, N]; with ``"exact"`` the plain
    version of ``far_match_batch``."""
    b = data.to(torch.int64)
    n64 = n.to(torch.int64)[:, None]
    far = (_match_candidates_fast if far_matcher == "fast"
           else _match_candidates_multi)
    return far(b, _key3(b, n64), n64, window, max_match)


def _match(data: torch.Tensor, n: torch.Tensor, config: DeflateConfig):
    """Stages 1+2 with the lazy deferral: (dist, length) [B, N] of lanes
    data uint8[B, N] of lengths n int32[B]."""
    return _match_lanes(data, n, config.window, config.max_match,
                        config.window > MAX_WINDOW, config.far_matcher,
                        config.lazy)


def _match_lanes(data: torch.Tensor, n: torch.Tensor, window: int,
                 max_match: int, use_sort_matcher: bool, far_matcher: str,
                 lazy: bool):
    """``_match`` by the JAX package's switches: the sort-based far
    matcher where ``use_sort_matcher``, else the ``match2`` kernel, which
    takes windows up to 256.  The exact far matcher is the ``farmatch``
    kernel off the CPU; the fast one is torch glue on any device."""
    if use_sort_matcher and far_matcher != "fast" and data.device.type != "cpu":
        dist, length = far_match_batch(data, n, window, max_match)
    elif use_sort_matcher:
        dist, length = _far_match_plain(data, n, window, max_match, far_matcher)
    elif window <= MAX_WINDOW:
        dist, length = match_bitplane_batch(data, n, window, max_match)
    else:
        raise NotImplementedError(
            "window > 256 without the sort matcher (the JAX package's "
            "windowed sweep) is not ported; use_sort_matcher=True takes it")
    if lazy:
        # one-step lazy matching: a literal here where the next position
        # holds a strictly longer match
        defer = (length >= 3) & (_ahead(length, 1) > length)
        length = torch.where(defer, 0, length)
    return dist, length


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """1 << e, elementwise (e >= 0)."""
    return torch.bitwise_left_shift(torch.ones_like(e), e)


def _kraft(lengths: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Kraft sum of each row in units of 2^-max_bits (0 = unused symbol)."""
    used = lengths > 0
    return torch.where(used, _pow2((max_bits - lengths).clamp_min(0)), 0).sum(-1)


def _kraft_complete(lengths: torch.Tensor, max_bits: int) -> torch.Tensor:
    """bool[...]: the code of each row is exactly complete (zlib rejects
    incomplete literal and code-length trees)."""
    return _kraft(lengths, max_bits) == (1 << max_bits)


def _bit_length(q: torch.Tensor) -> torch.Tensor:
    """floor(log2 q) + 1 for 1 <= q < 2^40, by compares against powers of
    two (torch has no count-leading-zeros)."""
    p = torch.bitwise_left_shift(
        torch.ones(40, dtype=torch.int64, device=q.device),
        torch.arange(40, device=q.device),
    )
    return (q[..., None] >= p).sum(-1)


def _overflow_rounds(f: torch.Tensor, lengths: torch.Tensor, max_bits: int,
                     rounds: int) -> torch.Tensor:
    """The JAX package's overflow repair in closed form: what ``rounds``
    rounds of "while the code is oversubscribed, lengthen the rarest
    symbol of length 1 .. max_bits - 1 (the first by index among equal
    counts)" add to lengths int64[B, S].

    The pick stays on one symbol until it reaches max_bits (counts do not
    change, and lengths only grow), so the rounds raise the candidates in
    (count, index) order, each to max_bits, the last only until the Kraft
    sum fits; a round after that changes nothing.  No read back to the
    host, and a fixed number of launches, where the rounds themselves
    would take hundreds."""
    B, S = f.shape
    dev = f.device
    can = (lengths > 0) & (lengths < max_bits)
    key = torch.where(can, f, 1 << 30) * S + torch.arange(S, device=dev)
    order = torch.argsort(key, dim=1)  # keys are unique
    cl = torch.gather(lengths, 1, order)
    cc = torch.gather(can, 1, order)
    steps = torch.where(cc, max_bits - cl, 0)
    top = _pow2((max_bits - cl).clamp_min(0))
    gain = torch.where(cc, top - 1, 0)  # Kraft units freed by a full raise
    gain_before = torch.cumsum(gain, 1) - gain
    steps_before = torch.cumsum(steps, 1) - steps
    excess = (_kraft(lengths, max_bits) - (1 << max_bits))[:, None]
    # the candidate whose raise brings the sum within the budget, and the
    # steps it takes: after t of them it has freed top - top / 2^t
    fixes = cc & (gain_before + gain >= excess)
    j = torch.argmax(fixes.to(torch.int64), dim=1, keepdim=True)  # first
    room = (torch.gather(gain_before + top, 1, j) - excess).clamp_min(1)
    cl_j = torch.gather(cl, 1, j)
    t = (max_bits - cl_j - (_bit_length(room) - 1)).clamp_min(0)
    need = torch.where((excess > 0) & fixes.any(1, keepdim=True),
                       torch.gather(steps_before, 1, j) + t,
                       torch.where(excess > 0, steps.sum(1, keepdim=True), 0))
    done = need.clamp(max=rounds)
    raised = torch.minimum((done - steps_before).clamp_min(0), steps)
    return torch.zeros_like(lengths).scatter(1, order, raised)


def _assign_code_lengths(freq: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Length-limited prefix-code lengths int64[B, S] of frequencies
    int64[B, S], row by row.  The JAX package's rule, step for step:
    lengths ceil(log2(total / f)) clipped to [1, max_bits]; 48 rounds that
    lengthen the rarest shortenable symbol while the code is
    oversubscribed; two sweeps over the levels max_bits .. 2 that shorten
    the most frequent symbols of a level (ties by index, a stable sort)
    while the budget allows; a lone symbol gets length 1."""
    f = freq.to(torch.int64)
    B, S = f.shape
    total = f.sum(1, keepdim=True).clamp_min(1)
    active = f > 0
    nactive = active.sum(1, keepdim=True)
    fm = f.clamp_min(1)
    q = total // fm
    blen = _bit_length(q.clamp_min(1))
    is_pow2 = (q & (q - 1)) == 0
    ceil_log = torch.where(is_pow2, blen - 1, blen)
    bump = is_pow2 & (total % fm != 0)
    lengths = (ceil_log + bump.to(torch.int64)).clamp(1, max_bits)
    lengths = torch.where(active, lengths, 0)

    unit = 1 << max_bits
    big = 1 << 30
    lengths = lengths + _overflow_rounds(f, lengths, max_bits, 48)

    for _ in range(2):  # deficit tightening, coarse to fine
        for lvl in range(max_bits, 1, -1):
            c = 1 << (max_bits - lvl)
            k = torch.div(unit - _kraft(lengths, max_bits), c,
                          rounding_mode="floor")
            at_l = lengths == lvl
            key = torch.where(at_l, -f, big)
            order = torch.argsort(key, dim=1, stable=True)
            rank = torch.argsort(order, dim=1, stable=True)
            promote = at_l & (rank < k[:, None])
            lengths = lengths - promote.to(torch.int64)
    return torch.where((nactive == 1) & active, 1, lengths)


def _canonical_codes(lengths: torch.Tensor) -> torch.Tensor:
    """RFC 1951 canonical codes int64[B, S] (MSB-first) of lengths
    int64[B, S]; 0 for unused symbols."""
    B, S = lengths.shape
    dev = lengths.device
    valid = lengths > 0
    sym = torch.arange(S, device=dev)
    order = torch.argsort(torch.where(valid, lengths, 99) * S + sym, dim=1)
    len_sorted = torch.gather(lengths, 1, order).clamp(0, 16)
    bl_count = torch.zeros(B, 17, dtype=torch.int64, device=dev).scatter_add(
        1, lengths.clamp(0, 16), valid.to(torch.int64)
    )
    next_code = torch.zeros(B, 17, dtype=torch.int64, device=dev)
    for L in range(1, 17):
        next_code[:, L] = (next_code[:, L - 1] + bl_count[:, L - 1]) << 1
    cum_before = torch.cumsum(bl_count, 1) - bl_count
    rank = sym - torch.gather(cum_before, 1, len_sorted)
    code_sorted = torch.gather(next_code, 1, len_sorted) + rank
    codes = torch.zeros_like(lengths).scatter(1, order, code_sorted)
    return torch.where(valid, codes, 0)


def _revbits(x: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
    """The low nbits (1..16) of each x, bit-reversed."""
    x = x & 0xFFFF
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return (x >> (16 - nbits)) & (_pow2(nbits) - 1)


def _rle_code_lengths(L: torch.Tensor, ops_cap: int = 320):
    """RFC 1951 3.2.7 run-length encoding of code lengths int64[B, S]:
    (sym, extra, ebits int64[B, ops_cap], nops int64[B]) with symbols 0-15,
    16 (repeat the previous length 3-6 times), 17 (3-10 zeros) and 18
    (11-138 zeros).  Slots past nops are 0."""
    B, S = L.shape
    dev = L.device
    i = torch.arange(S, device=dev)
    prev = torch.cat([torch.full((B, 1), -1, dtype=L.dtype, device=dev),
                      L[:, :-1]], 1)
    new_run = (i == 0) | (L != prev)
    rid = torch.cumsum(new_run.to(torch.int64), 1) - 1
    nruns = rid[:, -1:] + 1
    run_val = torch.zeros_like(L).scatter_reduce(
        1, rid, torch.where(new_run, L, 0), "amax")
    run_start = torch.full_like(L, S).scatter_reduce(
        1, rid, torch.where(new_run, i, S), "amin")
    nxt = torch.gather(run_start, 1, (i + 1).clamp(max=S - 1).expand(B, S))
    next_start = torch.where(i + 1 < nruns, nxt, S)
    ln = torch.where(i < nruns, next_start - run_start, 0).clamp_min(0)

    v = run_val
    k18, r1 = ln // 138, ln % 138
    count_zero = k18 + (r1 >= 3).to(torch.int64) + torch.where(r1 < 3, r1, 0)
    rem = (ln - 1).clamp_min(0)
    k16f, r2 = rem // 6, rem % 6
    count_nz = 1 + k16f + (r2 >= 3).to(torch.int64) + torch.where(r2 < 3, r2, 0)
    counts = torch.where(i < nruns, torch.where(v == 0, count_zero, count_nz), 0)
    op_off = torch.cumsum(counts, 1) - counts
    nops = counts.sum(1)

    o = torch.arange(ops_cap, device=dev).expand(B, ops_cap).contiguous()
    r = (torch.searchsorted(op_off, o, right=True) - 1).clamp(0, S - 1)
    j = o - torch.gather(op_off, 1, r)
    rv, rk18, rr1, rk16f, rr2 = (torch.gather(x, 1, r)
                                 for x in (v, k18, r1, k16f, r2))

    # zero run: k18 ops of 18, then one 18 or 17 for the tail of >= 3
    full18 = j < rk18
    tail18 = (j == rk18) & (rr1 >= 11)
    tail17 = (j == rk18) & (rr1 >= 3) & ~tail18
    z_sym = torch.where(full18 | tail18, 18, torch.where(tail17, 17, 0))
    z_ext = torch.where(full18, 138 - 11, torch.where(
        tail18, rr1 - 11, torch.where(tail17, rr1 - 3, 0)))
    z_eb = torch.where(full18 | tail18, 7, torch.where(tail17, 3, 0))
    # nonzero run: the length itself, then 16s of 6, then one 16 of 3..5
    full16 = (j >= 1) & (j <= rk16f)
    part16 = (j == rk16f + 1) & (rr2 >= 3)
    n_sym = torch.where(full16 | part16, 16, rv)
    n_ext = torch.where(full16, 3, torch.where(part16, rr2 - 3, 0))
    n_eb = torch.where(full16 | part16, 2, 0)

    live = o < nops[:, None]
    zero_run = rv == 0
    sym = torch.where(live, torch.where(zero_run, z_sym, n_sym), 0)
    extra = torch.where(live, torch.where(zero_run, z_ext, n_ext), 0)
    ebits = torch.where(live, torch.where(zero_run, z_eb, n_eb), 0)
    return sym, extra, ebits, nops


def _dynamic_trees(start, is_match, litlen_sym, dsym, lebits, debits):
    """Per-lane dynamic trees and header, and the static-or-dynamic choice
    by exact bit count: the ``dyntrees`` kernel off the CPU, which reads
    the token starts and their symbols alone (a start is a match where its
    symbol is a length code, and the extra bits are alike under either
    tree), the plain version on it."""
    if start.device.type != "cpu":
        count("dyntrees")
        return dyn_trees_batch(start, litlen_sym, dsym)
    return _dynamic_trees_plain(start, is_match, litlen_sym, dsym, lebits, debits)


def _dynamic_trees_plain(start, is_match, litlen_sym, dsym, lebits, debits):
    """Per-lane dynamic trees and header, and the static-or-dynamic choice
    by exact bit count.  Returns (use_dyn bool[B], lit_code, lit_len
    int64[B, 288], dist_code, dist_len int64[B, 32], hdr_vals, hdr_nbs
    int64[B, 340]); the tables and header are the static ones, and the
    header widths 0, where a lane keeps static trees."""
    B = start.shape[0]
    dev = start.device
    i64 = torch.int64
    s_lit_code = _table("STATIC_LITLEN_CODES_REV", dev).expand(B, 288)
    s_lit_len = _table("STATIC_LITLEN_LENGTHS", dev).expand(B, 288)
    s_dist_code = _table("STATIC_DIST_CODES_REV", dev).expand(B, 32)

    lit_freq = torch.zeros(B, 287, dtype=i64, device=dev).scatter_add(
        1, torch.where(start, litlen_sym, 286), start.to(i64))[:, :286]
    lit_freq[:, 256] += 1  # end-of-block
    dist_freq = torch.zeros(B, 31, dtype=i64, device=dev).scatter_add(
        1, torch.where(is_match, dsym, 30), is_match.to(i64))[:, :30]
    # RFC 1951 wants at least one distance code even when none is used
    no_dist = dist_freq.sum(1) == 0
    dist_freq[:, 0] = torch.where(no_dist, 1, dist_freq[:, 0])
    # both trees in one batch: the zero counts that pad the distance rows
    # are unused symbols, which change no step of the rule
    both = _assign_code_lengths(torch.cat(
        [lit_freq, torch.nn.functional.pad(dist_freq, (0, 286 - 30))]), 15)
    lit_len, dist_len = both[:B], both[B:, :30]
    lit_code = _revbits(_canonical_codes(lit_len), lit_len.clamp_min(1))
    dist_code = _revbits(_canonical_codes(dist_len), dist_len.clamp_min(1))

    # header: HLIT = 286, HDIST = 30, HCLEN = 19, the 19 code-length code
    # lengths, then the 316 lengths run-length encoded
    rle_sym, rle_extra, rle_ebits, rle_n = _rle_code_lengths(
        torch.cat([lit_len, dist_len], 1))
    rle_live = torch.arange(rle_sym.shape[1], device=dev) < rle_n[:, None]
    cl_freq = torch.zeros(B, 20, dtype=i64, device=dev).scatter_add(
        1, torch.where(rle_live, rle_sym, 19), torch.ones_like(rle_sym))[:, :19]
    cl_len = _assign_code_lengths(cl_freq, 7)
    cl_code = _revbits(_canonical_codes(cl_len), cl_len.clamp_min(1))
    op_len = torch.gather(cl_len, 1, rle_sym)
    op_nbs = torch.where(rle_live, op_len + rle_ebits, 0)
    op_vals = torch.where(
        rle_live, torch.gather(cl_code, 1, rle_sym) | (rle_extra << op_len), 0)
    order = torch.as_tensor(T.CODE_LENGTH_ORDER, dtype=i64, device=dev)
    e0 = (286 - 257) | ((30 - 1) << 5) | ((19 - 4) << 10)
    hdr_vals = torch.cat([torch.full((B, 1), e0, dtype=i64, device=dev),
                          cl_len[:, order], op_vals], 1)
    hdr_nbs = torch.cat([torch.full((B, 1), 14, dtype=i64, device=dev),
                         torch.full((B, 19), 3, dtype=i64, device=dev),
                         op_nbs], 1)

    # exact bit counts of the tokens and end-of-block under either tree
    s_bits = torch.where(start, torch.gather(s_lit_len, 1, litlen_sym)
                         + torch.where(is_match, lebits + 5 + debits, 0), 0)
    d_bits = torch.where(start, torch.gather(lit_len, 1, litlen_sym)
                         + torch.where(is_match, lebits + debits + torch.gather(
                             dist_len, 1, dsym), 0), 0)
    tok_bits_static = s_bits.sum(1) + 7
    tok_bits_dyn = d_bits.sum(1) + lit_len[:, 256]
    dist_active = (dist_freq > 0).sum(1)
    trees_ok = (_kraft_complete(lit_len, 15) & _kraft_complete(cl_len, 7)
                & (_kraft_complete(dist_len, 15) | (dist_active <= 1)))
    allow = ((cl_freq > 0).sum(1) >= 2) & ((lit_freq > 0).sum(1) >= 2) & trees_ok
    use_dyn = allow & (hdr_nbs.sum(1) + tok_bits_dyn < tok_bits_static)

    u = use_dyn[:, None]
    pad2 = (0, 2)
    F = torch.nn.functional
    return (
        use_dyn,
        torch.where(u, F.pad(lit_code, pad2), s_lit_code),
        torch.where(u, F.pad(lit_len, pad2), s_lit_len),
        torch.where(u, F.pad(dist_code, pad2), s_dist_code),
        torch.where(u, F.pad(dist_len, pad2), 5),
        hdr_vals,
        torch.where(u, hdr_nbs, 0),
    )


def _encode_emissions(data, n, final, dist, length, dynamic: bool = False):
    """Stages 3-4 up to the bit offsets: (vals, nbs, offs int64[B, K],
    total_bits int64[B], ntok int32[B]).

    Static trees: entry 0 is the 3-bit block header, entries 1..N the
    token at each position (width 0 where none starts), entry N + 1 the
    end-of-block code.  ``dynamic``: each lane takes dynamic trees where
    they give fewer bits; the dynamic header's 340 entries follow the
    block header, and each position has two entries (literal/length code
    with its extras, then distance code with its extras), since dynamic
    codes reach 15 bits."""
    B, N = data.shape
    dev = data.device
    start = _greedy_parse(length, n)
    ln = length.to(torch.int64).clamp(0, 258)
    is_match = start & (ln >= 3)
    is_lit = start & ~is_match

    lsym = _table("LEN_TO_SYM", dev)[ln]
    litlen_sym = torch.where(is_lit, data.to(torch.int64), 257 + lsym)
    lextra = torch.where(is_match, _table("LEN_TO_EXTRA", dev)[ln], 0)
    lebits = torch.where(is_match, _table("LENGTH_EXTRA_BITS", dev)[lsym], 0)
    d = dist.to(torch.int64).clamp(0, 32768)
    dsym = _table("DIST_TO_SYM", dev)[d]
    dextra = torch.where(is_match, _table("DIST_TO_EXTRA", dev)[d], 0)
    debits = torch.where(is_match, _table("DIST_EXTRA_BITS", dev)[dsym], 0)

    zero = torch.zeros(B, 1, dtype=torch.int64, device=dev)
    if dynamic:
        (use_dyn, lit_code, lit_len, dist_code, dist_len, hdr_vals,
         hdr_nbs) = _dynamic_trees(start, is_match, litlen_sym, dsym,
                                   lebits, debits)
        btype = torch.where(use_dyn, 2, 1)
        eob_val = torch.where(use_dyn, lit_code[:, 256], 0)[:, None]
        eob_nb = torch.where(use_dyn, lit_len[:, 256], 7)[:, None]
        dlen = torch.where(is_match, torch.gather(dist_len, 1, dsym), 0)
        dcode = torch.where(is_match, torch.gather(dist_code, 1, dsym), 0)
    else:
        lit_code = _table("STATIC_LITLEN_CODES_REV", dev).expand(B, 288)
        lit_len = _table("STATIC_LITLEN_LENGTHS", dev).expand(B, 288)
        hdr_vals = hdr_nbs = zero[:, :0]
        btype = 1
        eob_val, eob_nb = zero, zero + 7  # the static end-of-block code is 0
        dlen = torch.where(is_match, 5, 0)
        dcode = torch.where(
            is_match, _table("STATIC_DIST_CODES_REV", dev)[dsym], 0)

    clen = torch.gather(lit_len, 1, litlen_sym)
    e0_val = torch.gather(lit_code, 1, litlen_sym) | (lextra << clen)
    e0_nb = torch.where(start, clen + lebits, 0)
    e12_val = dcode | (dextra << dlen)  # distance code, then its extras
    e12_nb = dlen + debits
    if dynamic:
        vals = torch.stack([e0_val, e12_val], 2).reshape(B, 2 * N)
        nbs = torch.stack([e0_nb, e12_nb], 2).reshape(B, 2 * N)
    else:
        # static codes: <= 13 + 18 bits, one value per position
        vals = e0_val | (e12_val << e0_nb)
        nbs = e0_nb + e12_nb
    hdr = final.to(torch.int64) | (btype << 1)  # BFINAL, BTYPE
    vals = torch.cat([hdr[:, None] + zero, hdr_vals, vals, eob_val], dim=1)
    nbs = torch.cat([zero + 3, hdr_nbs, nbs, eob_nb], dim=1)
    csum = torch.cumsum(nbs, dim=1)
    offs = csum - nbs
    ntok = start.sum(1).to(torch.int32)
    return vals, nbs, offs, csum[:, -1], ntok


def _emission_bits(config: DeflateConfig) -> int:
    """Widest emission value of the config, in bits."""
    if config.dynamic_encode:
        return 28  # 15-bit distance code + 13 extra bits
    # static: a length code of <= 8 bits with 1 extra bit and a distance
    # of <= 256 (<= 6 extra bits) fit in 20; else 13 + 18 bits
    return 20 if config.window <= 256 and config.max_match <= 18 else 31


def _bitpack_entries(vals, nbs, offs, emax: int):
    """Scatter-add entries of the bit-pack: (byte index int32[B, K],
    16-bit channels int32[B, C, K]).

    A value of emax bits shifted by its bit offset (<= 7) spans
    ceil((emax + 7) / 16) channels, added at bytes j, j+2, j+4."""
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
    int32[B]) with M = max_output_bytes(N).  ``config.dynamic_encode``
    gives each lane dynamic trees where they are smaller."""
    B, N = data.shape
    M = max_output_bytes(N)
    dev = data.device
    with span("td.encode.match", dev):
        lengths = lengths.to(torch.int32)
        dist, length = _match(data, lengths, config)
    with span("td.encode.emit", dev):
        vals, nbs, offs, total_bits, ntok = _encode_emissions(
            data, lengths, finals, dist, length, config.dynamic_encode
        )

    with span("td.encode.pack", dev):
        idx, ch = _bitpack_entries(vals, nbs, offs, _emission_bits(config))
        packed = mono_scatter_add(idx, ch, M + 8)
        # emissions are bit-disjoint, so every byte sum below is carry-free
        out = torch.zeros(B, M, dtype=torch.int32, device=dev)
        for c in range(ch.shape[1]):
            disp = 2 * c
            out[:, disp:] += packed[:, c, : M - disp] & 0xFF
            out[:, disp + 1 :] += (packed[:, c, : M - disp - 1] >> 8) & 0xFF
        return _finalize_block(data, lengths, finals, out, total_bits, M) + (ntok,)


def encode_block_bits(data: torch.Tensor, n, final, window: int, max_match: int,
                      use_sort_matcher: bool, lazy: bool = False,
                      dynamic_encode: bool = False, far_matcher: str = "exact"):
    """Encode one lane data uint8[N] of length n: (out uint8[M], out_len,
    ntok), 0-dim int32 tensors, with M = max_output_bytes(N); ``final``
    sets BFINAL.  ``tpu_deflate.ops.encode.encode_block_bits``, byte for
    byte: the lane as a batch of one through the matcher and the
    emissions, then a pack that adds each emission's five bytes into the
    output with one ``scatter_add_`` (the JAX package's single-lane pack,
    where the batch takes the bit-pack kernel)."""
    N = data.shape[0]
    M = max_output_bytes(N)
    dev = data.device
    rows = data.reshape(1, N)
    n1 = torch.as_tensor(n, device=dev).to(torch.int32).reshape(1)
    f1 = torch.as_tensor(final, device=dev).to(torch.bool).reshape(1)
    dist, length = _match_lanes(rows, n1, window, max_match, use_sort_matcher,
                                far_matcher, lazy)
    vals, nbs, offs, total_bits, ntok = _encode_emissions(
        rows, n1, f1, dist, length, dynamic_encode)
    # an emission of <= 31 bits shifted by its bit offset (<= 7) spans <= 5
    # bytes; emissions are bit-disjoint, so the byte sums are carry-free
    k = torch.arange(5, device=dev)
    v = torch.where(nbs > 0, vals, 0) << (offs & 7)
    contrib = ((v[..., None] >> (8 * k)) & 0xFF).to(torch.int32)
    tgt = ((offs >> 3)[..., None] + k).clamp(0, M - 1)
    out = torch.zeros(1, M, dtype=torch.int32, device=dev).scatter_add_(
        1, tgt.reshape(1, -1), contrib.reshape(1, -1))
    out, out_len = _finalize_block(rows, n1, f1, out, total_bits, M)
    return out[0], out_len[0], ntok[0]


def encode_block(data: torch.Tensor, n, final,
                 config: DeflateConfig = DeflateConfig()):
    """``encode_block_bits`` with the config's switches: the sort matcher
    for windows over 256."""
    return encode_block_bits(
        data, n, final, window=config.window, max_match=config.max_match,
        use_sort_matcher=config.window > MAX_WINDOW, lazy=config.lazy,
        dynamic_encode=config.dynamic_encode, far_matcher=config.far_matcher)
