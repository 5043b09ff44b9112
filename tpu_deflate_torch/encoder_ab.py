#!/usr/bin/env python3
"""Time the encoder of one or more checkouts of this repository, one
process a run, in the order given, on one CUDA card:

    python3 tpu_deflate_torch/encoder_ab.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``tpu_deflate_torch`` package (this
checkout, or another commit unpacked with ``git archive``).  Name each
root twice, in mirrored order (A B B A), so that a drift of the card
shows as a difference between the two runs of one root.  Every run
builds that root's kernels (into its own ``build/``), then measures on
8 MiB of the bench corpus, 128 lanes of 64 KiB:

  * ``match_bitplane_batch`` on the corpus, on seeded random bytes and on
    zeros (device ms: the profiler's time of all the call launches);
  * ``mono_scatter_add`` (its wrapper: any memset it launches counts) on
    the encoder's entries with static trees (C = 2) and dynamic trees
    (C = 3), the same with the batch's last lane cut to N / 8 and with
    every lane cut so, and on the one call of a ``one_block`` compress of
    1.125 MiB (one lane of 2 MiB), static and dynamic;
  * ``encode_blocks_batch``, static and dynamic: CUDA events around 10
    back-to-back calls, and the profiler's device time;
  * the API round trip ``compress_indexed`` + ``decompress_indexed``,
    static and dynamic: host clock, mean of 3 after one warm-up.

Each run prints one JSON line ``{"root": ..., "ms": {...}}``; then a
table of every measurement by run.  Outputs are not checked here:
``chip_smoke.py`` holds each kernel against its plain version.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(os.path.dirname(HERE), "tests", "data", "corpus.bin.gz")
SIZE = 8 << 20
SEED = 1951


def device_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds of fn(): the profiler's time of everything
    it launches on the card, over reps calls after one warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def event_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of fn() by CUDA events around reps calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def measure(root: str) -> dict:
    # the root's package, not this file's directory, which Python puts first
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch

    from tpu_deflate_torch import DeflateConfig, compress, compress_indexed, decompress_indexed
    from tpu_deflate_torch.kernels import build
    from tpu_deflate_torch.ops import encode as E

    build.library()
    dev = torch.device("cuda", 0)
    with open(CORPUS, "rb") as f:
        data = gzip.decompress(f.read())
    while len(data) < SIZE:
        data += data
    data = data[:SIZE]
    chunk = 1 << 16
    B = SIZE // chunk
    chunks = torch.frombuffer(bytearray(data), dtype=torch.uint8).reshape(B, chunk).to(dev)
    lens = torch.full((B,), chunk, dtype=torch.int32, device=dev)
    finals = torch.zeros(B, dtype=torch.bool, device=dev)
    finals[-1] = True
    M = E.max_output_bytes(chunk)
    scfg = DeflateConfig()
    dcfg = DeflateConfig(dynamic_encode=True)
    ms = {}

    gen = torch.Generator().manual_seed(SEED + 1)
    rnd = torch.randint(0, 256, (B, chunk), generator=gen, dtype=torch.uint8).to(dev)
    for what, rows in (("corpus", chunks), ("random", rnd),
                       ("zeros", torch.zeros_like(chunks))):
        ms[f"match2 {what}"] = device_ms(
            lambda: E.match_bitplane_batch(rows, lens, 256, 10))

    for cut in ("full", "last lane N/8", "every lane N/8"):
        clens = lens.clone()
        if cut == "last lane N/8":
            clens[-1] = chunk // 8
        elif cut == "every lane N/8":
            clens[:] = chunk // 8
        for cfg in (scfg, dcfg):
            d, n = E.match_bitplane_batch(chunks, clens, cfg.window, cfg.max_match)
            v, nb, off, _, _ = E._encode_emissions(chunks, clens, finals, d, n,
                                                   cfg.dynamic_encode)
            idx, ch = E._bitpack_entries(v, nb, off, E._emission_bits(cfg))
            ms[f"pack {cut} C={ch.shape[1]}"] = device_ms(
                lambda: E.mono_scatter_add(idx, ch, M + 8))
    ob = data[: 9 << 17]
    for cfg in (DeflateConfig(one_block=True),
                DeflateConfig(one_block=True, dynamic_encode=True)):
        calls = []
        pack = E.mono_scatter_add

        def spy(*args):
            calls.append(args)
            return pack(*args)

        E.mono_scatter_add = spy
        compress(ob, cfg, device=dev)
        E.mono_scatter_add = pack
        args = calls[0]
        ms[f"pack one_block C={args[1].shape[1]}"] = device_ms(lambda: pack(*args))

    for what, cfg in (("static", scfg), ("dynamic", dcfg)):
        enc = lambda: E.encode_blocks_batch(chunks, lens, finals, cfg)  # noqa: E731
        ms[f"encode {what} events"] = event_ms(enc)
        ms[f"encode {what} device"] = device_ms(enc, reps=5)
        decompress_indexed(*compress_indexed(data, cfg, device=dev), cfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            decompress_indexed(*compress_indexed(data, cfg, device=dev), cfg, device=dev)
        ms[f"round trip {what} host"] = (time.perf_counter() - t0) / 3 * 1e3
    return ms


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        print(json.dumps({"root": argv[1], "ms": measure(os.path.abspath(argv[1]))}),
              flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for root in argv:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print("measurement | " + " | ".join(r["root"] for r in runs))
    for key in runs[0]["ms"]:
        print(f"{key} | " + " | ".join(f"{r['ms'][key]:.4f}" for r in runs))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
