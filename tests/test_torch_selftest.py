"""tpu_deflate_torch's self-test, CLI and profiling helpers on the CPU:
the self-test passes with the JAX package's pinned sizes, the CLI round
trips a file at every level, and the profiler reports the JAX package's
fields."""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import io
import json
import pathlib
import subprocess
import sys
import zlib

import pytest

pytest.importorskip("jax")

import tpu_deflate.utils.profiling as jprof  # noqa: E402
import tpu_deflate_torch.utils.profiling as tprof  # noqa: E402
from tests.corpora import corpus  # noqa: E402
from tpu_deflate_torch import cli  # noqa: E402
from tpu_deflate_torch.selftest import _bench_corpus, run_selftest  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops here: the lanes are
    small, and under parallel test workers more threads only contend."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_selftest_passes_with_the_pins():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run_selftest(verbose=True, device="cpu")
    text = out.getvalue()
    for pin in ("(0x234 == 0x234)", "(0xff == 0xff)", "(0x21b == 0x21b)"):
        assert pin in text
    assert "FAIL" not in text and text.rstrip().endswith("SELFTEST PASSED")
    assert run_selftest(verbose=False, device="cpu")


def test_selftest_corpus_equal():
    from tpu_deflate.selftest import _bench_corpus as j_corpus

    assert _bench_corpus() == j_corpus() and len(_bench_corpus()) == 2200


def test_selftest_custom_config():
    from tpu_deflate_torch import DeflateConfig

    cfg = DeflateConfig(window=32768, max_match=258, chunk_size=1024, lazy=True)
    assert run_selftest(cfg, verbose=False, device="cpu")


@pytest.mark.parametrize("level", ["fast", "ref", "max"])
@pytest.mark.parametrize("container", ["zlib", "gzip"])
def test_cli_round_trip(tmp_path, level, container):
    data = corpus(1, 30000) + corpus(3, 2000) + corpus(1, 30000)[:9000]
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    gz = ["--gzip"] if container == "gzip" else []
    assert cli.main([str(src), "--level", level, "--device", "cpu", *gz]) == 0
    packed = tmp_path / ("in.bin.gz" if gz else "in.bin.zz")
    comp = packed.read_bytes()
    assert (gzip.decompress(comp) if gz else zlib.decompress(comp)) == data
    assert len(comp) < len(data) // 2
    back = tmp_path / "back.bin"
    args = [str(packed), "-d", "-o", str(back), "--level", level, "--device", "cpu"]
    if not gz:  # decompress reads zlib streams; gzip goes by its oracle
        assert cli.main(args) == 0
        assert back.read_bytes() == data
        assert cli.main([str(packed), "-d", "--device", "cpu"]) == 0
        assert src.read_bytes() == data  # the default name strips .zz


def test_cli_levels_equal_jax():
    from tpu_deflate import cli as jcli

    for level in ("fast", "ref", "max"):
        t, j = cli._config(level), jcli._config(level)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_cli_selftest_module():
    """python -m tpu_deflate_torch --selftest --device cpu exits 0."""
    r = subprocess.run(
        [sys.executable, "-m", "tpu_deflate_torch", "--selftest", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SELFTEST PASSED" in r.stdout
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu"])  # no FILE


def test_profiler_report_fields_equal():
    t = tprof.Profiler(device="cpu")
    j = jprof.Profiler()
    for p in (t, j):
        for _ in range(2):
            with p.stage("encode", nbytes=1 << 20) as c:
                sum(range(1000))
            assert c.calls >= 1
    tr, jr = json.loads(t.report()), json.loads(j.report())
    assert [sorted(r) for r in tr] == [sorted(r) for r in jr]
    assert tr[0]["name"] == "encode" and tr[0]["calls"] == 2
    assert tr[0]["bytes"] == 2 << 20 and tr[0]["seconds"] > 0
    assert ([f.name for f in dataclasses.fields(tprof.Counter)]
            == [f.name for f in dataclasses.fields(jprof.Counter)])
    jfields = {f.name for f in dataclasses.fields(jprof.Profiler)}
    assert jfields <= {f.name for f in dataclasses.fields(tprof.Profiler)}
    assert tprof.Counter("x").gbps == 0.0


def test_device_trace_writes_a_file(tmp_path):
    import torch

    with tprof.device_trace(str(tmp_path), device="cpu"):
        torch.arange(1000).cumsum(0)
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
