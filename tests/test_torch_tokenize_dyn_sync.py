"""A numpy model of the dynamic tokenizer kernel's schedule
(``tpu_deflate_torch/csrc/tokenize_dyn.cu`` on the pass engine of
``csrc/pass.cuh``): a pass's symbol starts found
by a fixed-point iteration over subsequences of S bits, each walk keeping
the bit offsets of its tokens in a slice of `cap` entries, then the cut
at the first terminal, block scans of tokens and bytes, and the slots
written only where the pass's tokens fit: a slot of a slice by decoding
its symbol again at the kept offset, the slots of a walk that overflowed
its slice by walking it again.  S, the thread count and `cap` are
parameters; a thread that owns several subsequences walks them in order.
The model also decodes every position of every pass through the kernel's
first-level tables (10 bits of a literal/length code, 9 of a distance
code, the limits for longer codes) and holds them to the plain decoder.

The lanes are zlib dynamic blocks at levels 1, 6 and 9, a Z_HUFFMAN_ONLY
block with a 1-bit literal code, a block built by hand whose widest
symbol is 48 bits (15-bit length and distance codes, 5 and 13 extra
bits), lanes that end in ERR_DIST, ERR_BAD_CODE and ERR_INPUT, lanes that
end in their header (status >= 0), and the same blocks resumed after
earlier tokens and output (tok0, TAB_OUTBASE); a token capacity of 300
makes some overflow.  The model must give all seven outputs of
``tokenize_dyn_plain``, fresh buffers and the caller's (``into``) alike;
the JAX package's ``tokenize(static_only=False)`` the same counts, output
bytes, end bit, error and tokens on the lanes that start at bit 0 with
nothing before them; and its Pallas
``tokenize_dyn_batch`` in interpret mode the tokens, counts, end bit and
error where that kernel applies (trees valid, literal codes of
MIN_LIT_LEN bits or more, a whole block in one pass)."""

from __future__ import annotations

import functools
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.corpora import corpus  # noqa: E402
from tests.test_torch_dynamic import _dict_raw, _dyn_header  # noqa: E402
from tests.test_torch_kernels import _zlib_raw  # noqa: E402
from tpu_deflate.kernels.tokenize_dyn import MIN_LIT_LEN  # noqa: E402
from tpu_deflate.kernels.tokenize_dyn import tokenize_dyn_batch as j_tok_dyn  # noqa: E402
from tpu_deflate.ops import decode as JD  # noqa: E402
from tpu_deflate_torch import lanes as L  # noqa: E402
from tpu_deflate_torch.kernels import tokenize as K  # noqa: E402
from tpu_deflate_torch.kernels import tokenize_dyn as KD  # noqa: E402
from tpu_deflate_torch.ops import decode as D  # noqa: E402
from tpu_deflate_torch.ops.header import chase_reach  # noqa: E402

NONE = np.iinfo(np.int64).max
LIT_BITS, DIST_BITS = 10, 9


# ---------------------------------------------------------------------------
# lanes
# ---------------------------------------------------------------------------


def _lanes():
    """(name, stream, end bit) per lane; each starts with its dynamic
    header at bit 0."""
    text = corpus(2, 2600)
    zl9 = _zlib_raw(text, 9)
    skew = bytes(2500) + bytes(np.random.default_rng(8).integers(
        0, 256, 120, dtype=np.uint8))
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 9, zlib.Z_HUFFMAN_ONLY)
    lanes = [
        ("zlib1", _zlib_raw(corpus(4, 2600), 1), None),
        ("zlib6", _zlib_raw(text, 6), None),
        ("zlib9", zl9, None),
        ("huffman_only", co.compress(skew) + co.flush(), None),
        ("wide", L.wide_block(), None),
        ("far", _dict_raw(text[300:2300], text[:300]), None),
        ("bad_code", L.bad_code_block(), None),
        ("truncated", zl9, 4 * len(zl9)),
        ("cl_oversub", _dyn_header(257, 1, [1] * 19, 1), None),
        ("truncated_header", zl9, 8 * 6),
    ]
    return [(name, s, 8 * len(s) if end is None else end)
            for name, s, end in lanes]


# the block after earlier output: (tok0, TAB_OUTBASE) of each lane, in the
# resumed copy of the batch
RESUME = {"zlib9": (5, 40), "far": (7, 300), "wide": (3, 9), "truncated": (2, 2),
          "cl_oversub": (4, 4), "huffman_only": (1, 1)}


@functools.lru_cache(maxsize=None)
def _batch():
    """The lanes, then resumed copies of the RESUME lanes: dict of names,
    rows, ends, the header parse's tab, starts, status and min_len, tok0,
    and `src`, the lane each row was copied from."""
    lanes = _lanes()
    M = max(len(s) for _, s, _ in lanes)
    rows = np.zeros((len(lanes), M), np.uint8)
    for i, (_, s, _) in enumerate(lanes):
        rows[i, : len(s)] = np.frombuffer(s, np.uint8)
    ends = np.array([e for _, _, e in lanes], np.int32)
    prep = D.dyn_header_params_batch(torch.from_numpy(rows), torch.from_numpy(ends))
    coded, starts, status = D.dyn_lanes(prep)
    assert bool(coded.all())
    names = [name for name, _, _ in lanes]
    src = np.array(list(range(len(names))) + [names.index(k) for k in RESUME])
    tab = prep["tab"].numpy()[src].copy()
    tab[len(names):, KD.TAB_OUTBASE] = [ob for _, ob in RESUME.values()]
    return dict(names=names + [f"{k}_resumed" for k in RESUME], rows=rows[src],
                ends=ends[src], tab=tab, starts=starts.numpy()[src],
                status=status.numpy()[src], min_len=prep["min_len"].numpy()[src],
                tok0=np.array([0] * len(names) + [k for k, _ in RESUME.values()],
                              np.int32), src=src, n_base=len(names))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _code_len(v, lim):
    return 16 - sum((v < lim[L]).astype(np.int64) for L in range(1, 16))


def luts(tab):
    """The kernel's first-level tables of one lane's packed table: (lut
    int64[1024], dlut int64[512]), fill_luts() of tokenize_dyn.cu."""
    t = tab.astype(np.int64)
    lit_sym, dist_sym = (x[0].numpy() for x in KD.rank_symbols(torch.from_numpy(tab[None])))
    out = []
    for bits, lim, rd, syms in ((LIT_BITS, t[KD.TAB_LIT_LIM:][:16], t[KD.TAB_LIT_RD:][:16], lit_sym),
                                (DIST_BITS, t[KD.TAB_DIST_LIM:][:16], t[KD.TAB_DIST_RD:][:16], dist_sym)):
        r = np.arange(1 << bits)
        vmin = np.array([int(f"{x:0{bits}b}"[::-1], 2) << (15 - bits) for x in r])
        nb = _code_len(vmin, lim)
        ok = (nb <= bits) & (_code_len(vmin | ((1 << (15 - bits)) - 1), lim) == nb)
        nbc = np.clip(nb, 1, 15)
        rank = (vmin >> (15 - nbc)) + rd[nbc]
        symp1 = np.where((rank >= 0) & (rank < len(syms)), syms[np.clip(rank, 0, len(syms) - 1)], 0)
        sym = symp1 - 1
        if bits == LIT_BITS:
            i = np.clip(sym - 257, 0, 28)
            eb = np.where((i < 8) | (i == 28), 0, (i >> 2) - 1)
            base = np.where(i == 28, 258, np.where(i < 8, i + 3, ((4 + (i & 3)) << eb) + 3))
            e = np.where(sym < 256, K.K_LIT | nb << 2 | sym << 9,
                         np.where(sym == 256, K.K_EOB | nb << 2,
                                  K.K_MATCH | nb << 2 | eb << 6 | base << 9))
            e = np.where((symp1 == 0) | (sym > 285), K.K_BAD | 1 << 2, e)
        else:
            ds = np.minimum(sym, 29)
            eb = np.where(ds < 2, 0, (ds >> 1) - 1)
            base = np.where(ds < 2, ds + 1, ((2 + (ds & 1)) << eb) + 1)
            e = np.where(symp1 == 0, 1 | 1 << 1, nb << 1 | eb << 5 | base << 9)
        out.append(np.where(ok, e, 0))
    return out


def check_lut_decode(bits, plane, room, lut, dlut):
    """Every position before room decodes through the first-level tables
    (the limits where an entry has width 0) to the plain decoder's
    symbol."""
    kind, adv, ta, tb = (x[:room] for x in plane)
    w = bits[:room]
    e = lut[w & ((1 << LIT_BITS) - 1)]
    nb = (e >> 2) & 15
    k = e & 3
    eb = (e >> 6) & 7
    length = (e >> 9) + ((w >> nb) & ((1 << eb) - 1))
    doff = nb + eb
    wd = w >> doff
    d = dlut[wd & ((1 << DIST_BITS) - 1)]
    dnb = (d >> 1) & 15
    deb = (d >> 5) & 15
    dist = (d >> 9) + ((wd >> dnb) & ((1 << deb) - 1))
    slow = (nb == 0) | ((k == K.K_MATCH) & (dnb == 0))
    bad = (k == K.K_BAD) | ((k == K.K_MATCH) & (d & 1 == 1))
    gk = np.where(bad, K.K_BAD, k)
    gadv = np.where(bad, 1, np.where(k == K.K_MATCH, doff + dnb + deb, nb))
    gta = np.where(gk == K.K_LIT, e >> 9, np.where(gk == K.K_MATCH, length, 0))
    gtb = np.where(gk == K.K_MATCH, dist, 0)
    fast = ~slow
    for g, want in zip((gk, gadv, gta, gtb), (kind, adv, ta, tb)):
        np.testing.assert_array_equal(g[fast], want[fast])
    return int(slow.sum())


def _walk(plane, e, lo, hi, slices, cap):
    """Each subsequence's walk from e up to hi, in step (the threads of a
    warp): (exit, first terminal or NONE, its width, whether it is an
    end-of-block, tokens and output bytes before it, and the most that a
    distance reaches past the walk's own output); the bit offsets of the
    tokens from lo go into slices[:, k] while k < cap."""
    kind, adv, tav, tbv = plane
    pwin = kind.shape[0]
    p = e.copy()
    term = np.full_like(e, NONE)
    tadv = np.zeros_like(e)
    teob = np.zeros(e.shape, bool)
    n = np.zeros_like(e)
    prod = np.zeros_like(e)
    need = np.zeros_like(e)
    rows = np.arange(len(e))
    while True:
        act = p < hi
        if not act.any():
            return p, term, tadv, teob, n, prod, need
        q = np.minimum(p, pwin - 1)
        k, a = kind[q], adv[q]
        free = act & (term == NONE)
        is_term = free & ((k == K.K_EOB) | (k == K.K_BAD))
        term = np.where(is_term, p, term)
        tadv = np.where(is_term, a, tadv)
        teob = np.where(is_term, k == K.K_EOB, teob)
        tok = free & ~is_term
        m = tok & (k == K.K_MATCH)
        need = np.where(m, np.maximum(need, tbv[q] - prod), need)
        keep = tok & (n < cap)
        slices[rows[keep], n[keep]] = (p - lo)[keep]
        n += tok
        prod += np.where(tok, np.where(k == K.K_LIT, 1, tav[q]), 0)
        p = np.where(act, p + a, p)


def model_pass(plane, S, threads, cap, tp, total, tok_cap):
    """One pass over its candidate plane (kind, adv, ta, tb) int64[pwin]:
    (tokens [(slot, tk, ta, tb)], n, produced, cap_ok, too_far, cut or
    NONE, the cut's width, eob, the window's exit, rounds, entries,
    spilled walks)."""
    kind, adv, tav, tbv = plane
    pwin = kind.shape[0]
    nsub = -(-pwin // S)
    per = -(-nsub // threads)  # subsequences a thread, walked in order
    lo = np.arange(nsub, dtype=np.int64) * S
    hi = np.minimum(lo + S, pwin)
    ent = lo.copy()
    slices = np.zeros((nsub, cap), np.int64)
    rounds = 0
    while True:  # one round: each thread walks its subsequences in order
        rounds += 1
        res = [None] * 7
        new = ent.copy()
        for i in range(per):
            js = np.arange(i, nsub, per)  # the i-th subsequence of each thread
            part = slices[js]
            got = _walk(plane, ent[js], lo[js], hi[js], part, cap)
            slices[js] = part
            for r, g in zip(range(7), got):
                if res[r] is None:
                    res[r] = np.zeros(nsub, g.dtype)
                res[r][js] = g
            nxt = js + 1 < nsub
            if i + 1 < per:  # the thread's next subsequence, this round
                ent[js[nxt] + 1] = got[0][nxt]
            new[js[nxt] + 1] = got[0][nxt]
        changed = (new != ent).any()
        ent = new
        if not changed:
            break
    exits, term, tadv, teob, n, prod, need = res
    cut = int(term.min())
    live = ent <= cut
    n, prod = np.where(live, n, 0), np.where(live, prod, 0)
    n_before, p_before = np.cumsum(n) - n, np.cumsum(prod) - prod
    ntot, ptot = int(n.sum()), int(prod.sum())
    cap_ok = tp + ntot < tok_cap - 1
    far = bool((cap_ok & live & (need > total + p_before)).any())
    tokens = []
    spilled = np.flatnonzero(n > cap)
    if cap_ok:
        for j in np.flatnonzero(n):
            if n[j] <= cap:  # decoded again at the kept offsets
                ps = lo[j] + slices[j, : n[j]]
            else:  # walked again, writing its own slots
                ps, p = [], int(ent[j])
                while len(ps) < n[j]:
                    ps.append(p)
                    p += int(adv[p])
            for k, p in enumerate(ps):
                tokens.append((tp + int(n_before[j]) + k,
                               int(kind[p] == K.K_MATCH), int(tav[p]), int(tbv[p])))
    j = int(np.argmin(term))
    return dict(tokens=tokens, n=ntot, produced=ptot, cap_ok=cap_ok,
                too_far=far, cut=cut, cut_adv=int(tadv[j]),
                eob=bool(teob[j]), exit=int(exits[-1]), rounds=rounds,
                entries=ent, live=live, nsub=nsub, spilled=len(spilled))


def model_tokenize(rows, ends, tab, starts, status, tok0, tok_cap, pwin, S,
                   threads, cap, stats, into=None):
    """The kernel's lane loop with model_pass for a pass; the seven outputs
    of tokenize_dyn_batch as numpy int32.  Without into the slots outside
    the block's tokens are zero (the kernel's fresh buffers)."""
    B, Mw = rows.shape
    ext = torch.nn.functional.pad(torch.from_numpy(rows).to(torch.int64),
                                  (0, pwin // 8 + 16))
    lit_sym, dist_sym = KD.rank_symbols(torch.from_numpy(tab))
    out = np.zeros((3, B, tok_cap), np.int32) if into is None else np.stack(into).copy()
    st = np.zeros((4, B), np.int32)
    for b in range(B):
        end = int(ends[b])
        pos, tp, total = int(starts[b]), int(tok0[b]), int(tab[b, KD.TAB_OUTBASE])
        err, done, failed, first = int(max(status[b], 0)), False, False, True
        lut, dlut = luts(tab[b])
        while status[b] < 0 and not done and not failed and (
                first or (pos <= 8 * Mw and pos < end and tp < tok_cap - 1)):
            first = False
            args = (ext[b : b + 1], torch.tensor([pos]), torch.tensor([end]), pwin,
                    torch.from_numpy(tab[b : b + 1]), lit_sym[b : b + 1],
                    dist_sym[b : b + 1])
            plane = [x[0].numpy() for x in KD._dyn_plane(*args)]
            bits = K.bit_windows(args[0], args[1], pwin)[0].numpy()
            room = max(0, min(end - pos, pwin))
            slow = check_lut_decode(bits, plane, room, lut, dlut)
            r = model_pass(plane, S, threads, cap, tp, total, tok_cap)
            check_entries(plane, r)
            stats.append((r["rounds"], r["nsub"], r["spilled"], slow))
            for slot, *fields in r["tokens"]:
                out[:, b, slot] = fields
            hit = r["cut"] != NONE
            pos = pos + (r["cut"] + r["cut_adv"] if hit else r["exit"])
            if r["cap_ok"]:
                tp, total = tp + r["n"], total + r["produced"]
            if (hit and not r["eob"]) or r["too_far"] or not r["cap_ok"]:
                failed = True
                err = (K.ERR_DIST if r["too_far"] else
                       K.ERR_OVERFLOW if not r["cap_ok"] else K.ERR_BAD_CODE)
            else:
                done = r["eob"]
        if status[b] < 0 and not done and err == K.ERR_OK:
            err = K.ERR_OVERFLOW if tp >= tok_cap - 1 else K.ERR_INPUT
        st[:, b] = (tp, total, pos, err)
    return (*out, *st)


def check_entries(plane, r):
    """Every live entry is a true symbol start: reached from the pass's
    start by the chase of the plain version."""
    kind, adv = (torch.from_numpy(x)[None] for x in plane[:2])
    term = (kind == K.K_EOB) | (kind == K.K_BAD)
    reach = chase_reach(adv, term)[0].numpy()
    ent = r["entries"][r["live"]]
    ent = ent[ent < len(reach)]
    assert reach[ent].all()


# ---------------------------------------------------------------------------
# the references and the tests
# ---------------------------------------------------------------------------


def _config(name):
    M = _batch()["rows"].shape[1]
    return {"decode": (8 * M + 16, D.chunk_pwin(M)),  # the decode path's pass
            "pwin1088": (8 * M + 16, 17 << 6),        # lanes span many passes
            "cap300": (300, D.chunk_pwin(M))}[name]    # some lanes overflow


def _inputs():
    b = _batch()
    return [b[k] for k in ("rows", "ends", "tab", "starts", "status", "tok0")]


@functools.lru_cache(maxsize=None)
def _plain(config, with_into):
    tok_cap, pwin = _config(config)
    into = None
    if with_into:  # earlier tokens below tok0, garbage above the block's
        g = np.random.default_rng(3).integers(1, 99, (3, len(_batch()["names"]), tok_cap))
        into = [x.astype(np.int32) for x in g]
    got = KD.tokenize_dyn_plain(*map(torch.from_numpy, _inputs()), tok_cap, pwin,
                                None if into is None else list(map(torch.from_numpy, into)))
    return [x.numpy() for x in got], into


@functools.lru_cache(maxsize=None)
def _jax_xla(config):
    b = _batch()
    n = b["n_base"]
    tok_cap, pwin = _config(config)
    jtok = jax.jit(jax.vmap(lambda row, e: JD.tokenize(
        row, 0, tok_cap=tok_cap, end_bit=e, pwin=pwin, stop_at_eob=True,
        static_only=False)))
    return [np.asarray(x) for x in jtok(jnp.asarray(b["rows"][:n]),
                                        jnp.asarray(b["ends"][:n]))]


FIELDS = ("tk", "ta", "tb", "ntok", "out_total", "end_pos", "err")


@pytest.mark.parametrize("config", ["decode", "pwin1088", "cap300"])
@pytest.mark.parametrize("S,threads,cap", [
    (64, 1024, 62),   # the kernel's own at these windows: S >= 64
    (64, 1024, 6),    # slices that overflow: walks write their own slots
    (49, 8, 200),     # just wider than a symbol, several a thread
    (160, 1024, 40),  # the caller's buffers (into)
])
def test_schedule_model_equals_plain_and_jax(config, S, threads, cap):
    b = _batch()
    names, n_base = b["names"], b["n_base"]
    tok_cap, pwin = _config(config)
    with_into = S == 160
    plain, into = _plain(config, with_into)
    stats = []
    got = model_tokenize(*_inputs(), tok_cap, pwin, S, threads, cap, stats, into)
    for g, p, what in zip(got, plain, FIELDS):
        np.testing.assert_array_equal(g, p, err_msg=what)
    want = _jax_xla(config)  # its lanes start at bit 0, with no tokens before
    for g, w, what in zip(got[3:], want[3:], FIELDS[3:]):
        np.testing.assert_array_equal(g[:n_base], w, err_msg=what)
    for i in range(n_base):
        k = int(want[3][i])
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g[i, :k], w[i, :k], err_msg=names[i])
    codes = dict(zip(names, got[6].tolist()))
    assert all(r <= nsub for r, nsub, *_ in stats)
    assert max(r for r, *_ in stats) >= 2  # some guessed entry was off the chain
    assert sum(s for *_, s in stats) > 0  # long codes went to the limits
    if cap <= 8:  # short codes overflow a slice
        assert max(s for _, _, s, _ in stats) > 0
    if tok_cap == 300:
        assert codes["zlib9"] == codes["huffman_only"] == K.ERR_OVERFLOW
        return
    assert b["min_len"][names.index("huffman_only")] == 1
    assert codes["zlib1"] == codes["zlib6"] == codes["zlib9"] == K.ERR_OK
    assert codes["huffman_only"] == codes["wide"] == K.ERR_OK
    assert codes["far"] == K.ERR_DIST and codes["far_resumed"] == K.ERR_OK
    assert codes["bad_code"] == K.ERR_BAD_CODE
    assert codes["truncated"] in (K.ERR_BAD_CODE, K.ERR_INPUT)
    for lane in ("cl_oversub", "cl_oversub_resumed", "truncated_header"):
        assert b["status"][names.index(lane)] == codes[lane] >= 0


def test_plain_equals_pallas_interpret():
    """The Pallas kernel, where it applies: trees valid, literal codes of
    MIN_LIT_LEN bits or more, the block in one window; TAB_OUTBASE on the
    resumed lanes moves its ERR_DIST check as in the port."""
    b = _batch()
    names, tab, tok0 = b["names"], b["tab"], b["tok0"]
    plain, _ = _plain("decode", False)
    pw = JD._fused_pw(1000)  # its lanes hold whole blocks, in one window
    whole = np.array(["truncated" not in name for name in names])
    idx = np.flatnonzero((b["status"] < 0) & (b["min_len"] >= MIN_LIT_LEN)
                         & (b["ends"] <= pw - 64) & whole)
    assert {"zlib6", "zlib9", "far", "far_resumed"} <= {names[i] for i in idx}
    tok, ntok, tot, endp, err = (np.asarray(x) for x in j_tok_dyn(
        *(jnp.asarray(b[k][idx]) for k in ("rows", "ends", "tab", "starts")),
        pw=pw, interpret=True))
    tk, ta, tb, tp, gtot, pos, gerr = plain
    for j, i in enumerate(idx):
        k, t0 = int(ntok[j]), int(tok0[i])
        assert (tp[i], gtot[i], pos[i], gerr[i]) == (
            t0 + k, tab[i, KD.TAB_OUTBASE] + tot[j], endp[j], err[j]), names[i]
        if err[j] != K.ERR_OK:
            continue
        np.testing.assert_array_equal(tk[i, t0 : t0 + k], (tok[j, :k] >> 26) & 3)
        np.testing.assert_array_equal(ta[i, t0 : t0 + k], (tok[j, :k] >> 17) & 0x1FF)
        np.testing.assert_array_equal(tb[i, t0 : t0 + k], tok[j, :k] & 0x1FFFF)
