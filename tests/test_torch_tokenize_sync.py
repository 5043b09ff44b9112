"""A numpy model of the static tokenizer kernel's schedule
(``tpu_deflate_torch/csrc/tokenize.cu`` on the pass engine of
``csrc/pass.cuh``): a pass's symbol starts found by
a fixed-point iteration over subsequences of S bits, each walk keeping
its tokens in its subsequence's slice, then the cut at the first
terminal, block scans of tokens and bytes, and the slices copied out to
their slots, only where the pass's tokens fit.  S and the thread count
are parameters; a thread that owns several subsequences walks them in
order.

The model runs the kernel's block loop over the lanes of
``test_torch_kernels`` and seeded Z_FIXED streams and must give all seven
outputs of ``tokenize_static_plain`` and the JAX tokenizer's error, token
count, output bytes, end bit and tokens."""

from __future__ import annotations

import functools
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.corpora import corpus  # noqa: E402
from tests.test_torch_kernels import M, _rows, _token_lanes  # noqa: E402
from tpu_deflate.ops.decode import tokenize as j_tokenize  # noqa: E402
from tpu_deflate_torch.kernels import tokenize as K  # noqa: E402
from tpu_deflate_torch.ops.decode import chunk_pwin  # noqa: E402
from tpu_deflate_torch.ops.header import chase_reach  # noqa: E402

NONE = np.iinfo(np.int64).max


def _lanes():
    """The kernel tests' lanes and three seeded Z_FIXED streams."""
    lanes = list(_token_lanes())
    rng = np.random.default_rng(17)
    for i in range(3):
        words = [corpus(5 + i, 40)[: int(k)] for k in rng.integers(2, 12, 120)]
        payload = b" ".join(words)[:3500]
        co = zlib.compressobj(9, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
        s = co.compress(payload) + co.flush()
        lanes.append((f"fixed_{i}", s, 8 * len(s)))
    return lanes


def _walk(plane, e, hi, slices):
    """Each subsequence's walk from e up to hi, in step (the threads of a
    warp): (exit, first terminal or NONE, its width, whether it is an
    end-of-block, tokens and output bytes before it, and the most that a
    distance reaches past the walk's own output); the tokens (match, ta,
    tb) go into slices[:, k] of each walk."""
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
        r = rows[tok]
        slices[r, n[tok]] = np.stack([m[tok], tav[q][tok], tbv[q][tok]], 1)
        n += tok
        prod += np.where(tok, np.where(k == K.K_LIT, 1, tav[q]), 0)
        p = np.where(act, p + a, p)


def model_pass(plane, S, threads, tp, total, tok_cap):
    """One pass over its candidate plane (kind, adv, ta, tb) int64[pwin]:
    (tokens [(slot, tk, ta, tb)], n, produced, cap_ok, too_far, cut or
    NONE, the cut's width, eob, the window's exit, rounds, entries)."""
    pwin = plane[0].shape[0]
    nsub = -(-pwin // S)
    per = -(-nsub // threads)  # subsequences a thread, walked in order
    lo = np.arange(nsub, dtype=np.int64) * S
    hi = np.minimum(lo + S, pwin)
    ent = lo.copy()
    # a subsequence's slice: a token is at least 8 bits wide
    slices = np.zeros((nsub, -(-S // 8) + 1, 3), np.int64)
    rounds = 0
    while True:  # one round: each thread walks its subsequences in order
        rounds += 1
        res = [None] * 7
        new = ent.copy()
        for i in range(per):
            js = np.arange(i, nsub, per)  # the i-th subsequence of each thread
            part = slices[js]
            got = _walk(plane, ent[js], hi[js], part)
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
    if cap_ok:  # the slices copied out, in order, to their slots
        for j in np.flatnonzero(n):
            for k in range(int(n[j])):
                tokens.append((tp + int(n_before[j]) + k, *map(int, slices[j, k])))
    j = int(np.argmin(term))
    return dict(tokens=tokens, n=ntot, produced=ptot, cap_ok=cap_ok,
                too_far=far, cut=cut, cut_adv=int(tadv[j]),
                eob=bool(teob[j]), exit=int(exits[-1]), rounds=rounds,
                entries=ent, live=live, nsub=nsub)


def _bits(row, pos, n):
    """n bits of row (bytes, zero past the end) from bit pos."""
    b0 = pos >> 3
    w = int.from_bytes(row[b0 : b0 + 8].ljust(8, b"\0"), "little")
    return (w >> (pos & 7)) & ((1 << n) - 1)


def model_tokenize(rows, ends, tok_cap, pwin, S, threads, stats):
    """The kernel's block loop on each lane, with model_pass for a pass;
    the seven outputs of tokenize_static_batch as numpy int32."""
    B, Mw = rows.shape
    ext = torch.nn.functional.pad(torch.from_numpy(rows).to(torch.int64),
                                  (0, pwin // 8 + 16))
    out = np.zeros((3, B, tok_cap), np.int32)
    st = np.zeros((4, B), np.int32)
    for b in range(B):
        row, end = rows[b].tobytes(), int(ends[b])
        pos = tp = total = bfinal = err = 0
        mode = K.M_HEADER

        def in_bounds():
            return pos <= 8 * Mw and pos < end and tp < tok_cap - 1

        def header():
            nonlocal pos, tp, total, bfinal, mode, err
            bfinal, btype = _bits(row, pos, 1), _bits(row, pos + 1, 2)
            if btype == 0:
                p = (pos + 3 + 7) & ~7
                ln, nln = _bits(row, p, 16), _bits(row, p + 16, 16)
                out[:, b, tp] = (K.TK_STORED, ln, (p + 32) >> 3)
                tp, total, pos = tp + 1, total + ln, p + 32 + 8 * ln
                ok = ln == nln ^ 0xFFFF
                mode = (K.M_DONE if bfinal else K.M_HEADER) if ok else K.M_ERROR
                err = err if ok else K.ERR_STORED
            elif btype == 1:
                pos, mode = pos + 3, K.M_TOKENS
            else:
                mode = K.M_ERROR
                err = K.ERR_DYNAMIC if btype == 2 else K.ERR_METHOD

        def block_pass():
            nonlocal pos, tp, total, mode, err
            plane = [x[0].numpy() for x in K._static_plane(
                ext[b : b + 1], torch.tensor([pos]), torch.tensor([end]), pwin)]
            r = model_pass(plane, S, threads, tp, total, tok_cap)
            check_entries(plane, r)
            stats.append((r["rounds"], r["nsub"]))
            for slot, *fields in r["tokens"]:
                out[:, b, slot] = fields
            hit = r["cut"] != NONE
            pos = pos + (r["cut"] + r["cut_adv"] if hit else r["exit"])
            if r["cap_ok"]:
                tp, total = tp + r["n"], total + r["produced"]
            if (hit and not r["eob"]) or r["too_far"] or not r["cap_ok"]:
                mode = K.M_ERROR
                err = (K.ERR_DIST if r["too_far"] else
                       K.ERR_OVERFLOW if not r["cap_ok"] else K.ERR_BAD_CODE)
            else:
                mode = K.M_DONE if r["eob"] else K.M_TOKENS

        if in_bounds():
            header()
        while mode < K.M_DONE and in_bounds():
            if mode == K.M_HEADER:
                header()
            if mode == K.M_TOKENS:
                block_pass()
        clean = mode == K.M_DONE or (err == K.ERR_OK and pos >= end
                                     and mode == K.M_HEADER)
        if not clean and err == K.ERR_OK:
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


CONFIGS = {
    "decode": (M + 16, chunk_pwin(M)),  # the decode path's pass
    "pwin1088": (M + 16, 17 << 6),      # lanes span several passes
    "cap300": (300, chunk_pwin(M)),     # lanes that overflow their tokens
}


@functools.lru_cache(maxsize=None)
def _reference(config):
    """(lanes, rows, ends, plain outputs, JAX outputs) of a config."""
    tok_cap, pwin = CONFIGS[config]
    lanes = _lanes()
    rows, ends = _rows(lanes)
    plain = [x.numpy() for x in K.tokenize_static_plain(
        torch.from_numpy(rows), torch.from_numpy(ends), tok_cap, pwin)]
    jtok = jax.jit(jax.vmap(lambda row, e: j_tokenize(
        row, 0, tok_cap=tok_cap, end_bit=e, pwin=pwin, stop_at_eob=True,
        static_only=True)))
    want = [np.asarray(x) for x in jtok(jnp.asarray(rows), jnp.asarray(ends))]
    return lanes, rows, ends, plain, want


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("S,threads", [
    (8, 1024), (16, 256), (64, 32),  # entries that take many rounds
    (None, 1024),                    # the kernel's own: S >= 32, a thread each
])
def test_schedule_model_equals_plain_and_jax(config, S, threads):
    tok_cap, pwin = CONFIGS[config]
    lanes, rows, ends, plain, want = _reference(config)
    if S is None:
        S = max(32, -(-pwin // threads))
    stats = []
    got = model_tokenize(rows, ends, tok_cap, pwin, S, threads, stats)
    names = [name for name, _, _ in lanes]
    for g, p, what in zip(got, plain, ("tk", "ta", "tb", "ntok", "out_total",
                                       "end_pos", "err")):
        np.testing.assert_array_equal(g, p, err_msg=what)
    jtk, jta, jtb, jtp, jtot, jpos, jerr = want
    np.testing.assert_array_equal(got[6], jerr)
    np.testing.assert_array_equal(got[3], jtp)
    np.testing.assert_array_equal(got[4], jtot)
    np.testing.assert_array_equal(got[5], jpos)
    for i, name in enumerate(names):
        n = int(jtp[i])
        for g, w in zip(got[:3], (jtk, jta, jtb)):
            np.testing.assert_array_equal(g[i, :n], w[i, :n], err_msg=name)
    codes = dict(zip(names, got[6]))
    if tok_cap < M:
        assert codes["static_text"] == K.ERR_OVERFLOW
        assert not got[0][names.index("static_text")].any()
    rounds = [r for r, _ in stats]
    assert all(r <= nsub for r, nsub in stats)
    assert max(rounds) >= 2  # some guessed entry was off the chain
    if S <= 16:
        assert max(rounds) >= 3
