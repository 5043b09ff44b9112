"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (from process start to the first timed call): import the program,
load its kernels (built into ``build/`` in the checkout on the first run
there), cut the payloads from the seed, do the call's own set-up
(``calls/<call>.py``), and drive every payload once through the timed
call.  Then one
caller calls back to back for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics), or for the mix's ``trace_calls`` under the profiler
(``--trace 1``: its per-layer metrics).  Once the window has closed the
device's peak memory is read, the program's cached memory freed, and the
window's answers judged against the plain reference (``check.py``); each
number judged is printed beside its limit, last on standard error and last
in the result line.  The run fails, printing no result, where there is no
CUDA device, or where a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

_IMPORTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import check, corpus, manifest  # noqa: E402
from portbench.loop import Traffic, latencies_ms  # noqa: E402
from portbench.stats import END_TO_END, percentile  # noqa: E402

BANNED = {"jax", "jaxlib", "flax", "tpu_deflate"}


def log(*parts) -> None:
    print("portbench:", *parts, file=sys.stderr, flush=True)


def process_start() -> float:
    """When this process started, on the epoch clock: from /proc where it
    is there, else when this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def pin_caches() -> None:
    """Build and kernel caches at fixed places inside the checkout (the
    program's own kernels build into ``build/`` there already)."""
    build = manifest.ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def traced_window(traffic: Traffic, program, seed: int, seconds: float, cuda: bool):
    """The mix's ``trace_calls`` under the profiler, and the trace reduced."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace as tr

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        window = traffic.run(seed, seconds, calls=traffic.mix["trace_calls"],
                             span=record_function, log=log)
        if cuda:
            torch.cuda.synchronize()
    events = tr.export_events(prof)
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    with open(manifest.HERE / "peaks.json") as f:
        peak = json.load(f).get(kind)
    if peak is None:
        log(f"no peaks.json entry for {kind}: roofline shares left out")
    payloads = [c[2] for c in window.calls]
    t = tr.reduce(events, {traffic.span}, payloads, tr.hand_kernels(program.csrc()), peak)
    for c in t.calls:
        if c.payload in window.last:
            c.shape = traffic.call.shape(c.payload, window.last[c.payload])
    return window, t


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, program,
             started: float, cuda: bool = True) -> dict:
    """One run of the cell on ``program``; the result line's fields, with
    ``checks`` as {name: (value, limit)}."""
    import torch

    mix = cell["traffic"]
    log(f"set-up: program imported at {time.time() - started:.3f} s")
    payloads = corpus.payloads(seed, mix["payload_bytes"], mix["payloads"], mix["align"])
    traffic = Traffic(mix, program.config(cell["config"]["deflate"]), program, payloads)
    log(f"set-up: payloads cut, the call set up at {time.time() - started:.3f} s")
    traffic.warm()
    if cuda:
        torch.cuda.synchronize()
    setup = time.time() - started
    log(f"set-up: every payload called once at {setup:.3f} s")
    if trace:
        window, t = traced_window(traffic, program, seed, seconds, cuda)
    else:
        window = traffic.run(seed, seconds, log=log)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell["chips"],
              "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    if cuda:
        torch.cuda.empty_cache()
        device["power_limit"] = power_limit()
        log(f"card {device['power_limit']}")
    lat = latencies_ms(window)
    log(f"{len(window.calls)} calls ({window.failed} failed) in "
        f"{(max([c[1] or c[0] for c in window.calls]) - window.start):.3f} s, "
        f"latency median {percentile(lat, 50):.4f} ms, p95 {percentile(lat, 95):.4f} ms")
    metrics = {}
    result = {}
    if trace:
        device["busy_s"], device["window_s"] = t.busy_s, t.window_s
        for m in cell["per_layer"]:
            reader = manifest.load_module("metrics", m["name"])
            value = None if reader is None else reader.read(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = t.breakdown
    else:
        for m in cell["end_to_end"]:
            value = END_TO_END[m["name"]](window, setup)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t0 = time.time()
    checks = check.judge(window, traffic, cell["config"])
    log(f"judged the window's answers in {time.time() - t0:.3f} s")
    return {"correct": check.correct(checks), "attempted": len(window.calls),
            "failed": window.failed, "metrics": metrics, "device": device,
            **result, "checks": checks}


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    pin_caches()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(1)
    from portbench.program import Port

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), Port("cuda"),
                      started)
    found = banned_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
        return 3
    for name, (value, limit) in result["checks"].items():
        log(f"check {name} {value} limit {limit}")
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in result["checks"].items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
