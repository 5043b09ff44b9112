"""Runs of the harness on the CPU, past its look for a card, through the
port's plain paths at a small size: each cell once, then the control, each
planted fault and each weaker parse in the program's place, which must
come out not correct.  And what the processes load."""

import subprocess
import sys
import time

import pytest

from portbench import control, manifest
from portbench.program import Port
from portbench.run import run_cell

SMALL = {"payload_bytes": 2 * 65536 + 777, "sample": 4, "trace_calls": 2}


def small_cell(workload: str, ratio: float = 1.0) -> dict:
    """The cell at a small size, its ratio limit set for that size."""
    cell = manifest.cell(workload)
    cell["traffic"].update(SMALL)
    cell["config"]["limits"] = {"ratio": ratio}
    return cell


def run(cell, program, seed=2**31 + 5, trace=False):
    return run_cell(cell, seed, 0.3, trace, program, time.time(), cuda=False)


@pytest.mark.parametrize("workload, trace", [("w256-static.bulk", False),
                                             ("fw-dynamic.bulk", False),
                                             ("w256-static.bulk", True)])
def test_a_small_run_is_correct(workload, trace):
    r = run(small_cell(workload), Port("cpu"), trace=trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert all(v <= lim for v, lim in r["checks"].values())
    assert r["checks"]["ref_lanes_bad"] == (0, 0) and r["checks"]["max_dist"][0] > 0
    if trace:
        assert "encode.device_ms" in r["metrics"] and r["breakdown"]["idle_gaps"]
    else:
        assert {"encode_gbps", "compressed_ratio", "call_p95_ms", "setup_s"} <= set(r["metrics"])


@pytest.mark.parametrize("workload", ["w256-static.bulk", "fw-dynamic.bulk"])
@pytest.mark.parametrize("fault", ["control", *control.FAULTS])
def test_the_control_and_each_fault_are_not_correct(workload, fault):
    port = Port("cpu")
    program = control.SharedWindow(port) if fault == "control" else control.FAULTS[fault](port)
    assert not run(small_cell(workload), program)["correct"]


@pytest.mark.parametrize("workload, changes", [("w256-static.bulk", {"window": 128}),
                                               ("fw-dynamic.bulk", {"lazy": False}),
                                               ("fw-dynamic.bulk", {"far_matcher": "fast"})])
def test_a_weaker_parse_reads_a_higher_ratio(workload, changes):
    """Held at the program's own ratio, which it meets, a weaker parse
    fails on the ratio alone."""
    sound = run(small_cell(workload), Port("cpu"))["checks"]["ratio"][0]
    r = run(small_cell(workload, ratio=sound), control.Weaker(Port("cpu"), changes))
    assert r["checks"]["ratio"][0] > sound and not r["correct"]
    assert [k for k, (v, lim) in r["checks"].items() if v > lim] == ["ratio"]


def test_a_mix_names_its_call_module():
    from portbench.loop import Traffic

    mix = {**manifest.load_traffic("bulk"), "call": "no_such_call"}
    with pytest.raises(ValueError, match="calls/no_such_call.py"):
        Traffic(mix, None, Port("cpu"), [b""])


def test_the_run_loads_no_jax_and_the_reference_nothing_of_the_program():
    code = (
        "import sys, time\n"
        "from portbench import manifest, check, reference\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'tpu_deflate_torch']\n"
        "from portbench.run import run_cell, banned_modules\n"
        "from portbench.program import Port\n"
        "for kind in ('calls', 'metrics', 'rooflines'):\n"
        "    for p in (manifest.HERE / kind).glob('*.py'):\n"
        "        manifest.load_module(kind, p.stem)\n"
        "cell = manifest.cell('w256-static.bulk')\n"
        "cell['traffic'].update(payload_bytes=65536, sample=2)\n"
        "cell['config']['limits'] = {'ratio': 1.0}\n"
        "assert run_cell(cell, 7, 0.2, False, Port('cpu'), time.time(), cuda=False)['correct']\n"
        "print(banned_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_a_machine_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "w256-static.bulk",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("this machine has a card")
    assert out.stdout == ""
