"""tpu_deflate_torch's configuration, tables and checksums against the JAX
package's, and the port's independence from JAX."""

from __future__ import annotations

import dataclasses
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_deflate.config as jcfg  # noqa: E402
import tpu_deflate.ops.checksum as jck  # noqa: E402
import tpu_deflate.spec.huffman as jhuf  # noqa: E402
import tpu_deflate.spec.tables as jtab  # noqa: E402
import tpu_deflate_torch.config as tcfg  # noqa: E402
import tpu_deflate_torch.ops.checksum as tck  # noqa: E402
import tpu_deflate_torch.spec.huffman as thuf  # noqa: E402
import tpu_deflate_torch.spec.tables as ttab  # noqa: E402

TABLES = [
    "LENGTH_EXTRA_BITS", "LENGTH_BASE", "DIST_EXTRA_BITS", "DIST_BASE",
    "LEN_TO_SYM", "LEN_TO_EXTRA", "DIST_TO_SYM", "DIST_TO_EXTRA",
    "STATIC_LITLEN_LENGTHS", "STATIC_LITLEN_CODES", "STATIC_LITLEN_CODES_REV",
    "STATIC_DIST_LENGTHS", "STATIC_DIST_CODES", "STATIC_DIST_CODES_REV",
]
PRESETS = ["DEFAULT", "FAST_CONFIG", "REFERENCE_PARITY", "FULL_WINDOW",
           "DECOMPRESS_ONLY", "LOWLUT"]
CONFIGS = [
    {},
    {"window": 32768, "max_match": 258},
    {"fast": True},
    {"match10": False},
    {"low_lut": True},
    {"low_lut": True, "compress": False, "dynamic": False, "match10": False},
    {"compress": False},
    {"compress": False, "match10": False},
    {"window": 0},
    {"window": 40000},
    {"max_match": 2},
    {"max_match": 300},
    {"far_matcher": "slow"},
    {"chunk_size": 4096, "window": 32, "max_match": 5},
]
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal(name):
    a, b = getattr(jtab, name), getattr(ttab, name)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "name,lengths,bits",
    [("STATIC_LITLEN_TABLE", jtab.STATIC_LITLEN_LENGTHS, 9),
     ("STATIC_DIST_TABLE", jtab.STATIC_DIST_LENGTHS, 5)],
)
def test_static_decode_tables_equal(name, lengths, bits):
    np.testing.assert_array_equal(
        getattr(ttab, name), jhuf.build_decode_table(lengths, bits)
    )


@pytest.mark.parametrize("seed", range(4))
def test_huffman_codes_equal(seed):
    freqs = np.random.default_rng(seed).integers(0, 1000, 40)
    lengths = jhuf.code_lengths_from_freqs(freqs, 12)
    np.testing.assert_array_equal(
        thuf.canonical_codes(lengths), jhuf.canonical_codes(lengths)
    )
    np.testing.assert_array_equal(
        thuf.build_decode_table(lengths, 12),
        jhuf.build_decode_table(lengths, 12),
    )


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal(name):
    assert dataclasses.asdict(getattr(jcfg, name)) == dataclasses.asdict(
        getattr(tcfg, name)
    )


@pytest.mark.parametrize("fields", CONFIGS)
def test_legality_rules_equal(fields):
    def build(mod):
        try:
            return dataclasses.asdict(mod.DeflateConfig(**fields))
        except ValueError as e:
            return type(e)

    assert build(jcfg) == build(tcfg)


@pytest.mark.parametrize("n_rule", ["full", "partial", "empty"])
def test_adler32_state_equal(n_rule):
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (3, 6000), dtype=np.uint8)
    n = {"full": [6000] * 3, "partial": [5999, 17, 4096], "empty": [0, 1, 0]}
    n = np.array(n[n_rule], np.int32)
    a, b = tck.adler32_state(torch.from_numpy(data), torch.from_numpy(n))
    for i in range(3):
        ja, jb = jck.adler32_state(jnp.asarray(data[i]), int(n[i]))
        assert (int(a[i]), int(b[i])) == (int(ja), int(jb))
        assert ((int(b[i]) << 16) | int(a[i])) == zlib.adler32(
            data[i, : n[i]].tobytes()
        )


def test_adler32_pair_combine_equal():
    rng = np.random.default_rng(11)
    p = [rng.integers(0, 65521, 64), rng.integers(0, 65521, 64),
         rng.integers(0, 1 << 20, 64)]
    q = [rng.integers(1, 65521, 64), rng.integers(0, 65521, 64),
         rng.integers(0, 1 << 20, 64)]
    got = tck.adler32_pair_combine(
        [torch.from_numpy(x) for x in p], [torch.from_numpy(x) for x in q]
    )
    want = jck.adler32_pair_combine(
        [jnp.asarray(x, jnp.int32) for x in p],
        [jnp.asarray(x, jnp.int32) for x in q],
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_adler32_fold_matches_zlib():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (5, 3000), dtype=np.uint8)
    n = torch.tensor([3000, 3000, 1234, 0, 77], dtype=torch.int32)
    a, b = tck.adler32_state(torch.from_numpy(data), n)
    want = zlib.adler32(b"".join(data[i, : n[i]].tobytes() for i in range(5)))
    assert tck.adler32_fold(a, b, n) == want


def test_import_leaves_jax_out():
    """Importing every module, then decompress_gzip, a StreamDecompressor,
    a FULL_WINDOW compress and the self-test on the CPU, bring in neither
    jax nor tpu_deflate."""
    code = ("import gzip, sys, zlib, tpu_deflate_torch as td; "
            "import tpu_deflate_torch.kernels.expand2, "
            "tpu_deflate_torch.kernels.resolve, tpu_deflate_torch.ops.expand, "
            "tpu_deflate_torch.ops.foreign, tpu_deflate_torch.kernels.chase1, "
            "tpu_deflate_torch.kernels.tokenize_dyn, tpu_deflate_torch.ops.header, "
            "tpu_deflate_torch.lanes, tpu_deflate_torch.cli, "
            "tpu_deflate_torch.ref.deflate, tpu_deflate_torch.spec.bitstream, "
            "tpu_deflate_torch.utils.profiling; "
            "from tpu_deflate_torch.selftest import run_selftest; "
            "data = b'gzip and streaming, ' * 300; "
            "cfg = td.DeflateConfig(chunk_size=4096); "
            "g = td.compress_gzip_members(data, cfg, device='cpu'); "
            "assert td.decompress_gzip(g, cfg, device='cpu') == data; "
            "assert td.decompress_gzip(gzip.compress(data), device='cpu') == data; "
            "z = zlib.compress(data, 6); "
            "d = td.StreamDecompressor(cfg, device='cpu'); "
            "out = b''.join(d.decompress(z[i : i + 40]) for i in range(0, len(z), 40)); "
            "assert out + d.flush() == data; "
            "fw = td.DeflateConfig(**{**td.FULL_WINDOW.__dict__, 'chunk_size': 4096}); "
            "assert zlib.decompress(td.compress(data, fw, device='cpu')) == data; "
            "assert run_selftest(verbose=False, device='cpu'); "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'tpu_deflate' not in sys.modules, 'tpu_deflate imported'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_exports_equal():
    import tpu_deflate
    import tpu_deflate_torch

    assert tpu_deflate_torch.__all__ == tpu_deflate.__all__
    assert tpu_deflate_torch.__version__ == tpu_deflate.__version__
    for name in tpu_deflate_torch.__all__:
        assert hasattr(tpu_deflate_torch, name), name


def test_port_sources_name_no_jax():
    for path in (REPO / "tpu_deflate_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "tpu_deflate"), (
                    f"{path.name}: {line.strip()}"
                )
