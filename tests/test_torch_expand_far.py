"""Matches that reach before the start of their row: a byte whose source
lies before byte 0 takes byte 0's value, in the port's plain expanders
and its ``expand_batch`` as in the JAX package's ``expand_fused3``
(interpret mode) and ``expand_batch``.  A lane whose tokenizer reports
ERR_DIST holds such a match; the API raises on it, but every kernel must
still equal its plain version there, and the plain versions equal the
JAX package.  A match of distance 0 leaves its bytes zero (the JAX
package repeats the byte before it; no tokenizer makes such a match)."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_deflate.kernels.expand3 import expand_fused3 as j_expand3  # noqa: E402
from tpu_deflate.ops.decode import expand_batch as j_expand_batch  # noqa: E402
from tpu_deflate_torch import lanes as L  # noqa: E402
from tpu_deflate_torch.kernels.expand2 import expand_fused2_plain  # noqa: E402
from tpu_deflate_torch.kernels.expand3 import expand_fused3_plain  # noqa: E402
from tpu_deflate_torch.ops import expand as X  # noqa: E402

LANE, WANT = L.FAR_LANE, L.FAR_BYTES
far_lanes = L.far_token_lanes


def _fields(tk, ta, tb, tp):
    off, c1, total = X._expand_inputs(*map(torch.from_numpy, (tk, ta)),
                                      torch.from_numpy(tp))
    return off, c1, torch.from_numpy(tb), torch.from_numpy(tp), total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_far_matches_equal_jax(seed):
    tk, ta, tb, tp = far_lanes(seed)
    off, c1, tbt, tpt, total = _fields(tk, ta, tb, tp)
    out_cap = 2048 * (-(-int(total.max()) // 2048))
    rows = torch.zeros(len(tp), 1, dtype=torch.uint8)
    want3 = np.asarray(j_expand3(*(jnp.asarray(x.numpy()) for x in (off, c1, tbt, tpt, total)),
                                 out_cap=out_cap, interpret=True)).astype(np.uint8)
    jout, jtotal = j_expand_batch(jnp.zeros((len(tp), 1), jnp.uint8),
                                  *map(jnp.asarray, (tk, ta, tb, tp)), out_cap=out_cap)
    np.testing.assert_array_equal(np.asarray(jout), want3)
    np.testing.assert_array_equal(want3[0, :7], WANT)
    got = {
        "expand_fused3_plain": expand_fused3_plain(rows, off, c1, tbt, tpt, total, out_cap),
        "expand_fused2_plain": expand_fused2_plain(off, c1, tbt, tpt, total, out_cap),
        "expand_batch": X.expand_batch(rows, *map(torch.from_numpy, (tk, ta, tb, tp)),
                                       out_cap)[0],
    }
    for name, g in got.items():
        np.testing.assert_array_equal(g.numpy(), want3, err_msg=name)
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
    assert (tb[:, : tp.max()] > np.cumsum(np.where(tk == 0, 1, ta), 1)[:, : tp.max()]).any()


@pytest.mark.parametrize("out_cap", [1 << 17, 1 << 20])
def test_far_matches_long_rows_equal_jax(out_cap):
    """Rows above 2^16: the port's expand_batch routes to expand_fused2,
    the JAX package's to its per-byte fields."""
    tk, ta, tb, tp = far_lanes(3)
    rows = torch.zeros(len(tp), 1, dtype=torch.uint8)
    got, total = X.expand_batch(rows, *map(torch.from_numpy, (tk, ta, tb, tp)), out_cap)
    want, jtotal = j_expand_batch(jnp.zeros((len(tp), 1), jnp.uint8),
                                  *map(jnp.asarray, (tk, ta, tb, tp)), out_cap=out_cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
    assert got[0, :7].tolist() == WANT


def test_distance_zero_stays_zero():
    """A match of distance 0, which no tokenizer produces, leaves its bytes
    zero in both plain expanders.  The JAX package differs here: both its
    routes collapse such a run as distance 1 and repeat the byte before
    it."""
    tk = np.array([[0, 1, 0]], np.int32)
    ta = np.array([[65, 4, 67]], np.int32)
    tb = np.array([[0, 0, 0]], np.int32)
    tp = np.array([3], np.int32)
    off, c1, tbt, tpt, total = _fields(tk, ta, tb, tp)
    rows = torch.zeros(1, 1, dtype=torch.uint8)
    for g in (expand_fused3_plain(rows, off, c1, tbt, tpt, total, 128),
              expand_fused2_plain(off, c1, tbt, tpt, total, 128)):
        assert g[0, :7].tolist() == [65, 0, 0, 0, 0, 67, 0]
    want, _ = j_expand_batch(jnp.zeros((1, 1), jnp.uint8),
                             *map(jnp.asarray, (tk, ta, tb, tp)), out_cap=128)
    assert np.asarray(want)[0, :6].tolist() == [65, 65, 65, 65, 65, 67]
