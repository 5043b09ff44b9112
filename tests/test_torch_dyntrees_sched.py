"""A numpy model of the dynamic-trees kernel's schedule on the card
(``tpu_deflate_torch/csrc/dyntrees.cu``, ``kernels/dyntrees.py``): one
block a lane counts the literal/length symbol of every token start and
the distance symbol of every start whose symbol is a length code (>= 257),
adds the end-of-block, forces distance code 0 where the lane has no match,
then builds each tree by the plain rule with block-wide steps: lengths
ceil(log2(total / f)) clipped to [1, max_bits] and a histogram of them;
the overflow repair as its 48 rounds, the pick the least (count, index)
among lengths 1 .. max_bits - 1 by one block minimum, raised in place
while the code is oversubscribed; the two deficit sweeps over the levels
max_bits .. 2, each level's promotions counted from the histogram and
taken by each symbol's rank by (-count, index) among its level; a lone
symbol at length 1.  Canonical codes from the histogram and each
symbol's rank by index within its length, bit-reversed.  One thread
run-length encodes the 316 lengths and counts the 19 code-length
symbols; their tree by the same rule; the header; one block sum of each
symbol's count times its length change against the static trees plus the
header's widths decides the choice (the extra bits cancel).

The model must equal the plain ``ops.encode._dynamic_trees`` and the JAX
package's tree functions, field by field, on the hand-built lanes of
``tpu_deflate_torch/lanes.py`` (no token; one literal; literals alone, so
distance code 0 is forced; all 286 symbols with counts whose 15-bit clip
oversubscribes the code past what the 48 rounds repair; a code-length
tree whose ceil rule asks 9 bits, clipped to 7; dynamic header and tokens
taking exactly the static trees' bits, so static wins the tie) and on a
lane of the corpus through the encoder.  Positions that start no token
hold garbage symbols, which the count skips.  The lengths alone are held
to both on counts the repair fixes at 15 and at 7 bits."""

from __future__ import annotations

import functools
import gzip
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_deflate.ops.encode as JE  # noqa: E402
import tpu_deflate_torch.ops.encode as TE  # noqa: E402
from tpu_deflate_torch import lanes  # noqa: E402
from tpu_deflate_torch.kernels.dyntrees import dyn_trees_batch  # noqa: E402
from tpu_deflate_torch.spec import tables as T  # noqa: E402

ROUNDS = 48  # csrc/dyntrees.cu's kRounds
ORDER = np.asarray(T.CODE_LENGTH_ORDER)
CORPUS = pathlib.Path(__file__).resolve().parent / "data" / "corpus.bin.gz"
FIELDS = ("use_dyn", "lit_code", "lit_len", "dist_code", "dist_len", "hdr_vals",
          "hdr_nbs")


def static_lit():
    """RFC 1951 3.2.6's fixed literal/length code, (codes bit-reversed,
    lengths) of the 288 symbols, in closed form as the kernel has it."""
    s = np.arange(288)
    nb = np.select([s < 144, s < 256, s < 280], [8, 9, 7], 8)
    code = np.select([s < 144, s < 256, s < 280], [0x30 + s, 0x190 + s - 144, s - 256],
                     0xC0 + s - 280)
    return revbits(code, nb), nb


def revbits(code, nb):
    """The low 16 bits of code reversed, then shifted down to nb bits."""
    code = np.asarray(code, np.int64) & 0xFFFF
    rev = np.zeros_like(code)
    for k in range(16):
        rev |= ((code >> k) & 1) << (15 - k)
    return rev >> (16 - np.asarray(nb, np.int64))


def model_lengths(f, max_bits: int):
    """One tree's lengths as the block builds them: (lengths, Kraft sum in
    units of 2^-max_bits, active symbols)."""
    f = np.asarray(f, np.int64)
    S = len(f)
    unit = 1 << max_bits
    total, nactive = int(f.sum()), int((f > 0).sum())
    L = np.zeros(S, np.int64)
    for i in np.flatnonzero(f):
        q = total // f[i]
        blen = int(q).bit_length()
        pow2 = q & (q - 1) == 0
        L[i] = min(max((blen - 1 if pow2 else blen) + (pow2 and total % f[i] != 0), 1),
                   max_bits)
    cnt = np.bincount(L, minlength=16)
    kraft = sum(int(cnt[lv]) << (max_bits - lv) for lv in range(1, max_bits + 1))
    # the repair: one block minimum of (count, index, length) a pick, the
    # pick raised while the rounds last and the code is oversubscribed
    rounds = ROUNDS
    while kraft > unit and rounds > 0:
        can = (L > 0) & (L < max_bits)
        key = np.where(can, (f << 13) | (np.arange(S) << 4) | L, np.iinfo(np.int64).max)
        pick = int(key.argmin())
        lv = l0 = int(key[pick] & 15)
        while lv < max_bits and kraft > unit and rounds > 0:
            kraft -= 1 << (max_bits - lv - 1)
            lv += 1
            rounds -= 1
        L[pick] = lv
        cnt[l0] -= 1
        cnt[lv] += 1
    # the sweeps: a level's promotions from the histogram, each symbol of
    # the level by its rank among them
    for _ in range(2):
        for lvl in range(max_bits, 1, -1):
            c = 1 << (max_bits - lvl)
            D = unit - kraft
            k = D // c if D >= 0 else -1
            p = min(k, int(cnt[lvl]))
            if p <= 0:
                continue
            at = L == lvl
            rank = np.array([int((at & ((f > f[i]) | ((f == f[i]) & (np.arange(S) < i)))).sum())
                             for i in range(S)])
            L = np.where(at & (rank < k), lvl - 1, L)
            cnt[lvl] -= p
            cnt[lvl - 1] += p
            kraft += p * c
    if nactive == 1:
        L = np.where(f > 0, 1, L)
        kraft = 1 << (max_bits - 1)
    return L, kraft, nactive


def model_codes(L):
    """Canonical codes, bit-reversed: next_code from the histogram, plus
    each symbol's rank by index among the symbols of its length."""
    blc = np.bincount(L[L > 0], minlength=16)
    out = np.zeros(len(L), np.int64)
    for i in np.flatnonzero(L):
        nc = 0
        for lv in range(1, L[i] + 1):
            nc = (nc + (blc[lv - 1] if lv > 1 else 0)) << 1
        out[i] = revbits(nc + int((L[:i] == L[i]).sum()), L[i])
    return out


def model_rle(L):
    """One thread's walk of the runs: (symbol, extra) ops."""
    ops = []
    i = 0
    while i < len(L):
        v, j = int(L[i]), i + 1
        while j < len(L) and L[j] == v:
            j += 1
        ln = j - i
        if v == 0:
            ops += [(18, 127)] * (ln // 138)
            r1 = ln % 138
            ops += [(18, r1 - 11)] if r1 >= 11 else [(17, r1 - 3)] if r1 >= 3 else [(0, 0)] * r1
        else:
            ops.append((v, 0))
            ops += [(16, 3)] * ((ln - 1) // 6)
            r2 = (ln - 1) % 6
            ops += [(16, r2 - 3)] if r2 >= 3 else [(v, 0)] * r2
        i = j
    return ops


EBITS = {16: 2, 17: 3, 18: 7}


def model_lane(start, lsym, dsym):
    """The kernel's outputs for one lane, as numpy arrays by FIELDS."""
    lf = np.bincount(lsym[start], minlength=286)
    lf[256] += 1  # end-of-block
    df = np.bincount(dsym[start & (lsym >= 257)], minlength=30)
    dff = df.copy()
    if df.sum() == 0:
        dff[0] = 1
    lit_len, lit_kraft, lit_active = model_lengths(lf, 15)
    dist_len, dist_kraft, dist_active = model_lengths(dff, 15)
    lit_code, dist_code = model_codes(lit_len), model_codes(dist_len)
    ops = model_rle(np.concatenate([lit_len, dist_len]))
    clf = np.bincount([s for s, _ in ops], minlength=19)
    cl_len, cl_kraft, cl_active = model_lengths(clf, 7)
    cl_code = model_codes(cl_len)
    hdr_vals = np.zeros(340, np.int64)
    hdr_nbs = np.zeros(340, np.int64)
    hdr_vals[0], hdr_nbs[0] = (286 - 257) | ((30 - 1) << 5) | ((19 - 4) << 10), 14
    hdr_vals[1:20], hdr_nbs[1:20] = cl_len[ORDER], 3
    for o, (s, x) in enumerate(ops):
        hdr_vals[20 + o] = cl_code[s] | (x << cl_len[s])
        hdr_nbs[20 + o] = cl_len[s] + EBITS.get(s, 0)
    s_code, s_len = static_lit()
    diff = (int(hdr_nbs.sum()) + int((lf * (lit_len - s_len[:286])).sum())
            + int((df * (dist_len - 5)).sum()))
    allow = (cl_active >= 2 and lit_active >= 2 and lit_kraft == 1 << 15
             and cl_kraft == 1 << 7 and (dist_kraft == 1 << 15 or dist_active <= 1))
    use = allow and diff < 0
    pad = lambda x: np.pad(x, (0, 2))  # noqa: E731
    return {
        "use_dyn": np.array(use),
        "lit_code": pad(lit_code) if use else s_code,
        "lit_len": pad(lit_len) if use else s_len,
        "dist_code": pad(dist_code) if use else revbits(np.arange(32), 5),
        "dist_len": pad(dist_len) if use else np.full(32, 5),
        "hdr_vals": hdr_vals,
        "hdr_nbs": hdr_nbs if use else np.zeros(340, np.int64),
    }, {"diff": diff, "allow": allow, "lit_len": lit_len, "dist_len": dist_len,
        "cl_len": cl_len, "lf": lf, "df": df, "clf": clf, "lit_kraft": lit_kraft}


# --- the JAX package's tree functions, composed as its encoder does -------


@functools.lru_cache(maxsize=None)
def _jit(name: str, *static):
    fn = getattr(JE, name)
    return jax.jit(lambda x: fn(x, *static))


def jax_lane(lf, df):
    """(lengths, codes of lit, dist and code-length trees, RLE ops, header
    vals and widths, dynamic bits less static ones) by the JAX package's
    functions from the lane's counts."""
    i32 = lambda x: jnp.asarray(np.asarray(x), jnp.int32)  # noqa: E731
    lit_len = _jit("_assign_code_lengths_jax", 15)(i32(lf))
    dff = np.where((df.sum() == 0) & (np.arange(30) == 0), 1, df)
    dist_len = _jit("_assign_code_lengths_jax", 15)(i32(dff))
    codes = lambda L: JE._revbits_vec(_jit("_canonical_codes_jax")(L), jnp.maximum(L, 1))  # noqa: E731
    sym, extra, ebits, nops = _jit("_rle_code_lengths_jax")(jnp.concatenate([lit_len, dist_len]))
    live = np.arange(320) < int(nops)
    clf = np.bincount(np.asarray(sym)[live], minlength=19)
    cl_len = _jit("_assign_code_lengths_jax", 7)(i32(clf))
    cl_code = np.asarray(codes(cl_len))
    cl_len_n, sym = np.asarray(cl_len), np.asarray(sym)
    op_vals = np.where(live, cl_code[sym] | (np.asarray(extra) << cl_len_n[sym]), 0)
    op_nbs = np.where(live, cl_len_n[sym] + np.asarray(ebits), 0)
    s_len = static_lit()[1]
    return {
        "lit_len": np.asarray(lit_len), "dist_len": np.asarray(dist_len),
        "lit_code": np.asarray(codes(lit_len)), "dist_code": np.asarray(codes(dist_len)),
        "cl_len": cl_len_n,
        "hdr_vals": np.concatenate([[(286 - 257) | ((30 - 1) << 5) | ((19 - 4) << 10)],
                                    cl_len_n[ORDER], op_vals]),
        "hdr_nbs": np.concatenate([[14], [3] * 19, op_nbs]),
        "diff_tokens": int((lf * (np.asarray(lit_len) - s_len[:286])).sum())
        + int((df * (np.asarray(dist_len) - 5)).sum()),
    }


# --- the lanes (the hand-built ones in tpu_deflate_torch/lanes.py) ------


def corpus_lane():
    """The encoder's inputs to the trees on 16 KiB of the corpus, at window
    256 with matches up to 258 (the full window's lengths), captured at
    ``_dynamic_trees`` through ``_encode_emissions``."""
    with gzip.open(CORPUS, "rb") as f:
        data = f.read(1 << 20)[-(1 << 14):]
    rows = torch.frombuffer(bytearray(data), dtype=torch.uint8)[None]
    n = torch.tensor([len(data)], dtype=torch.int32)
    dist, length = TE._match_lanes(rows, n, 256, 258, False, "exact", True)
    seen = []
    plain = TE._dynamic_trees

    def spy(*args):
        seen.append(args)
        return plain(*args)

    TE._dynamic_trees = spy
    try:
        TE._encode_emissions(rows, n, torch.tensor([True]), dist, length, True)
    finally:
        TE._dynamic_trees = plain
    start, _, lsym, dsym = (a[0].numpy() for a in seen[0][:4])
    return start, lsym, dsym


def case(name: str):
    return corpus_lane() if name == "corpus" else lanes.tree_edge_lane(name)


def plain_lane(start, lsym, dsym):
    """``_dynamic_trees`` on the lane as a batch of one, with each match's
    extra bits as the encoder gives them."""
    s, ls, ds = (torch.as_tensor(x)[None] for x in (start, lsym, dsym))
    is_match = s & (ls >= 257)
    lx = torch.as_tensor(T.LENGTH_EXTRA_BITS, dtype=torch.int64)[(ls - 257).clamp(0, 28)]
    dx = torch.as_tensor(T.DIST_EXTRA_BITS, dtype=torch.int64)[ds]
    out = TE._dynamic_trees(s, is_match, ls, ds, torch.where(is_match, lx, 0),
                            torch.where(is_match, dx, 0))
    return {k: v[0].numpy() for k, v in zip(FIELDS, out)}


CASES = [*lanes.TREE_EDGE_LANES, "corpus"]


def ceil_rule(f, max_bits: int):
    """The lengths before the repair and their Kraft sum."""
    L = np.zeros(len(f), np.int64)
    total = int(np.sum(f))
    for i in np.flatnonzero(f):
        q = total // int(f[i])
        pow2 = q & (q - 1) == 0
        L[i] = q.bit_length() - pow2 + (pow2 and total % int(f[i]) != 0)
    return L, int(np.where(L > 0, 2.0 ** (max_bits - np.minimum(L, max_bits)), 0).sum())


def holds_what_it_claims(name, info, got):
    """Each hand-built lane exercises the step its name says."""
    lf, clf = info["lf"], info["clf"]
    if name == "empty":
        assert lf.sum() == 1 and not got["use_dyn"]
    elif name == "literals_only":
        assert info["df"].sum() == 0 and info["dist_len"][0] == 1 and got["use_dyn"]
    elif name == "over_15_bits":
        assert (lf > 0).all() and ceil_rule(lf, 15)[1] > 1 << 15
        assert info["lit_kraft"] > 1 << 15 and not got["use_dyn"]  # 48 rounds did not do
    elif name == "cl_clipped":
        assert ceil_rule(clf, 7)[0].max() > 7
    elif name == "static_tie":
        assert info["allow"] and info["diff"] == 0 and not got["use_dyn"]


@pytest.mark.parametrize("name", CASES)
def test_schedule_model_equals_plain_and_jax(name):
    start, lsym, dsym = case(name)
    got, info = model_lane(start, lsym, dsym)
    want = plain_lane(start, lsym, dsym)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}: {k}")
    j = jax_lane(info["lf"], info["df"])
    for k in ("lit_len", "dist_len", "cl_len"):
        np.testing.assert_array_equal(info[k], j[k], err_msg=f"{name}: {k} against JAX")
    np.testing.assert_array_equal(got["hdr_vals"], j["hdr_vals"])
    if got["use_dyn"]:
        np.testing.assert_array_equal(got["lit_code"][:286], j["lit_code"])
        np.testing.assert_array_equal(got["dist_code"][:30], j["dist_code"])
        np.testing.assert_array_equal(got["hdr_nbs"], j["hdr_nbs"])
    assert info["diff"] == int(j["hdr_nbs"].sum()) + j["diff_tokens"]
    holds_what_it_claims(name, info, got)


def tree_counts(name: str):
    """Counts of one tree and its max_bits, for the lengths alone."""
    if name == "lit_repaired":  # 11 rounds of the repair, then complete
        f = np.array([1 << k for k in range(17, -1, -1) if 257938 >> k & 1]
                     + [16] * 262 + [2] * 2 + [1] * 10, np.int64)
        return f, 15
    if name == "lit_capped":  # the 48 rounds end oversubscribed
        f = lanes.over_15_counts()[0]
        f[256] = 1
        return f, 15
    if name == "cl_oversubscribed":  # exact shares of 256 and four clipped
        return np.array([128, 64, 0, 32, 16, 8, 4, 1, 1, 1, 1] + [0] * 8, np.int64), 7
    # counts halving by 1.6, as deep as the code-length tree gets
    return np.array([int(1000 / 1.6 ** k) + 1 for k in range(19)], np.int64), 7


@pytest.mark.parametrize("name", ["lit_repaired", "lit_capped", "cl_oversubscribed",
                                  "cl_deep"])
def test_lengths_model_equals_plain_and_jax(name):
    f, max_bits = tree_counts(name)
    L, kraft, _ = model_lengths(f, max_bits)
    assert ceil_rule(f, max_bits)[1] > 1 << max_bits or name == "cl_deep"
    plain = TE._assign_code_lengths(torch.as_tensor(f)[None], max_bits)
    np.testing.assert_array_equal(L, plain[0].numpy())
    np.testing.assert_array_equal(
        L, np.asarray(_jit("_assign_code_lengths_jax", max_bits)(jnp.asarray(f, jnp.int32))))
    assert kraft == int(TE._kraft(plain, max_bits)[0])
    assert (kraft == 1 << max_bits) == (name != "lit_capped")
    np.testing.assert_array_equal(
        model_codes(L), TE._revbits(TE._canonical_codes(plain), plain.clamp_min(1))[0].numpy())


def test_cpu_tensors_take_the_plain_trees():
    """``_dynamic_trees`` on CPU tensors is the plain version and launches
    nothing; the kernel's wrapper refuses CPU tensors."""
    start, lsym, dsym = (torch.as_tensor(x)[None] for x in case("literals_only"))
    before = dyn_trees_batch.launches
    zero = torch.zeros_like(lsym)
    got = TE._dynamic_trees(start, start & (lsym >= 257), lsym, dsym, zero, zero)
    want = TE._dynamic_trees_plain(start, start & (lsym >= 257), lsym, dsym, zero, zero)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dyn_trees_batch.launches == before
    with pytest.raises(ValueError, match="expected cuda"):
        dyn_trees_batch(start, lsym, dsym)
    with pytest.raises(ValueError, match="int64"):
        dyn_trees_batch(start, lsym.to(torch.int32), dsym)
