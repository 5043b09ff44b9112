#!/usr/bin/env python3
"""Time the kernels and paths of one or more checkouts of this repository,
one process a run, in the order given, on one CUDA card:

    python3 tpu_deflate_torch/kernel_ab.py [--only encode|decode] ROOT [ROOT ...]

Each ROOT is a directory that holds a ``tpu_deflate_torch`` package (this
checkout, or another commit unpacked with ``git archive``).  Name each
root twice, in mirrored order (A B B A), so that a drift of the card
shows as a difference between the two runs of one root.  Every run
builds that root's kernels (into its own ``build/``), then measures on
8 MiB of the bench corpus the encoder (``--only encode``), the decoder
(``--only decode``), or both:

encode, 128 lanes of 64 KiB:
  * ``match_bitplane_batch`` on the corpus, on seeded random bytes and on
    zeros (device ms: the profiler's time of all the call launches);
  * ``mono_scatter_add`` (its wrapper: any memset it launches counts) on
    the encoder's entries with static trees (C = 2) and dynamic trees
    (C = 3), the same with the batch's last lane cut to N / 8 and with
    every lane cut so, and on the one call of a ``one_block`` compress of
    1.125 MiB (one lane of 2 MiB), static and dynamic;
  * ``_dynamic_trees`` on the arguments it gets in ``FULL_WINDOW``'s
    encode of the 128 lanes (device ms: the ``dyntrees`` kernel where the
    root has it, else the torch glue), and the plain version
    ``_dynamic_trees_plain`` on the same, where the root has it;
  * ``encode_blocks_batch``, static, dynamic and ``FULL_WINDOW``: CUDA
    events around 10 back-to-back calls, and the profiler's device time;
  * the API round trip ``compress_indexed`` + ``decompress_indexed``,
    static, dynamic and ``FULL_WINDOW``: host clock, mean of 3 after one
    warm-up.

decode, device ms unless said:
  * ``expand_fused2`` on the second 512 KiB segment of ``decompress`` of
    zlib -6 of the 8 MiB (one lane of 624640 bytes), on the 8 long rows
    of ``decompress_indexed`` at ``chunk_size=1<<20``, and on a distance-1
    run over one row of 2^20 bytes;
  * ``ent_from_phi`` and ``tokenize_dyn_hier`` (whose time includes it) on
    a block a third of the way into that -6 stream (T = 8192), and by the
    profiler's split the time of its own two kernels, K3d (the walk) and
    K1d (the candidates and maps), and K1d on the stream's shortest block
    (the most bit positions past its end);
  * ``visited_from_adv`` on a dynamic header of that stream (T = 128);
  * ``resolve_roots`` on the segment that ``decompress`` hands it for the
    stored mix at -6 (1 MiB of the corpus, 256 KiB of seeded random bytes,
    the next MiB, as ``chip_smoke.py`` builds it) and on a distance-1 run
    over a whole segment (624640 positions);
  * ``decode_rows_batch`` of the 8 long rows, as ``decompress_indexed``
    calls it;
  * ``decompress`` of the zlib -6 stream: host clock, mean of 3 after one
    warm-up.

Each run prints one JSON line ``{"root": ..., "ms": {...}}``; then a
table of every measurement by run ("-" where a root has no such path).  Outputs are not checked here beyond
the decodes' bytes: ``chip_smoke.py`` holds each kernel against its plain
version.
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


def device_split(fn, reps: int = 10) -> dict:
    """Mean device milliseconds of fn() by launch name: the profiler's
    time of everything it launches on the card, over reps calls after one
    warm-up; {} where a try saw no device time, after three tries (a short
    profile sometimes comes back without kernels).  The program's spans
    (``td.*``), which the profiler also sets on the device's timeline, are
    no launches and are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.name.startswith("td."):
                ms = e.time_range.elapsed_us() / 1e3 / reps
                split[e.name] = split.get(e.name, 0.0) + ms
        if sum(split.values()) > 0:
            return split
    return {}


def device_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds of fn(), every launch summed; nan where
    the profiler saw none."""
    split = device_split(fn, reps)
    return sum(split.values()) if split else float("nan")


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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"kernel_ab: {what}")


def spy(module, name: str, calls: list):
    """Record every call's positional arguments of module.name; returns
    the original function."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        calls.append(args)
        return fn(*args, **kw)

    setattr(module, name, wrapper)
    return fn


def encode_ms(data: bytes, dev) -> dict:
    import torch

    from tpu_deflate_torch import (
        FULL_WINDOW,
        DeflateConfig,
        compress,
        compress_indexed,
        decompress_indexed,
    )
    from tpu_deflate_torch.ops import encode as E

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
        pack = spy(E, "mono_scatter_add", calls)
        compress(ob, cfg, device=dev)
        E.mono_scatter_add = pack
        args = calls[0]
        ms[f"pack one_block C={args[1].shape[1]}"] = device_ms(lambda: pack(*args))

    calls = []
    trees = spy(E, "_dynamic_trees", calls)
    E.encode_blocks_batch(chunks, lens, finals, FULL_WINDOW)
    E._dynamic_trees = trees
    ms["dyntrees full window device"] = device_ms(lambda: trees(*calls[0]))
    if hasattr(E, "_dynamic_trees_plain"):
        ms["dyntrees plain full window device"] = device_ms(
            lambda: E._dynamic_trees_plain(*calls[0]), reps=3)

    for what, cfg in (("static", scfg), ("dynamic", dcfg), ("full window", FULL_WINDOW)):
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


def decode_ms(data: bytes, dev) -> dict:
    import zlib

    import torch

    from tpu_deflate_torch import DeflateConfig, compress_indexed, decompress, decompress_indexed
    from tpu_deflate_torch import api as A
    from tpu_deflate_torch.kernels import tokenize_dyn as KD
    from tpu_deflate_torch.ops import expand as X
    from tpu_deflate_torch.ops import foreign as F

    ms = {}
    zs6 = zlib.compress(data, 6)
    segs, maps, blocks, headers = [], [], [], []
    spied = [(X, "expand_fused2", segs), (KD, "ent_from_phi", maps),
             (F, "tokenize_dyn_hier", blocks), (F, "visited_from_adv", headers)]
    fns = [spy(m, f, calls) for m, f, calls in spied]
    check(decompress(zs6, device=dev) == data, "zlib -6 did not decode")
    for (m, f, _), fn in zip(spied, fns):
        setattr(m, f, fn)
    expand2, ent, hier, visit = fns
    mid = len(blocks) // 3
    ms["expand_fused2 -6 segment"] = device_ms(lambda: expand2(*segs[1]))
    ms["ent_from_phi T=8192"] = device_ms(lambda: ent(*maps[mid]))
    split = device_split(lambda: hier(*blocks[mid]))
    ms["tokenize_dyn_hier -6 block"] = sum(split.values()) if split else float("nan")
    for key, part in (("K3d", "k3d_kernel"), ("K1d", "k1d_kernel")):
        ms[f"tokenize_dyn_hier -6 block, {key}"] = sum(
            v for k, v in split.items() if part in k) if split else float("nan")
    short = min(blocks, key=lambda a: int(a[1][0]))  # the most dead bits
    split = device_split(lambda: hier(*short))
    ms["tokenize_dyn_hier shortest -6 block, K1d"] = sum(
        v for k, v in split.items() if "k1d_kernel" in k) if split else float("nan")
    ms["visited_from_adv -6 header"] = device_ms(lambda: visit(*headers[mid % len(headers)]))

    gen = torch.Generator().manual_seed(SEED)
    noise = torch.randint(0, 256, (256 << 10,), generator=gen, dtype=torch.uint8)
    mixed = data[: 1 << 20] + bytes(noise.numpy()) + data[1 << 20 : 2 << 20]
    chains = []
    resolve = spy(X, "resolve_roots", chains)
    check(decompress(zlib.compress(mixed, 6), device=dev) == mixed,
          "the stored mix did not decode")
    X.resolve_roots = resolve
    check(len(chains) >= 1 and chains[0][0].shape == (1, F.SEG_CAP),
          f"{len(chains)} resolve_roots calls")
    ms["resolve_roots stored-mix -6 segment"] = device_ms(lambda: resolve(*chains[0]))
    at = torch.arange(F.SEG_CAP, device=dev)
    d1 = ((at - 1).clamp_min(0).to(torch.int32)[None],
          torch.randint(0, 256, (1, F.SEG_CAP), generator=gen,
                        dtype=torch.int32).to(dev))
    ms["resolve_roots distance-1 run 624640"] = device_ms(lambda: resolve(*d1))

    lcfg = DeflateConfig(chunk_size=1 << 20)
    lstream, lindex = compress_indexed(data, lcfg, device=dev)
    long_exp, long_dec = [], []
    decode = spy(A, "decode_rows_batch", long_dec)
    fn = spy(X, "expand_fused2", long_exp)
    check(decompress_indexed(lstream, lindex, lcfg, device=dev) == data,
          "the long rows did not round-trip")
    A.decode_rows_batch, X.expand_fused2 = decode, fn
    args = long_exp[0]
    check(args[0].shape[0] == 8 and args[5] == 1 << 20, "not 8 long rows")
    ms["expand_fused2 long rows 8 x 2^20"] = device_ms(lambda: expand2(*args), reps=5)
    rows, ends = long_dec[0]
    ms["long-row decode_rows_batch"] = device_ms(lambda: decode(
        rows, ends, out_cap=1 << 20, tok_cap=(1 << 20) + 16, static_only=True), reps=5)

    n_run = ((1 << 20) - 1) // 258  # a literal, then matches of 258 at distance 1
    tk = torch.ones(1, n_run + 1, dtype=torch.int32)
    ta = torch.full_like(tk, 258)
    tb = torch.ones_like(tk)
    tk[0, 0], ta[0, 0], tb[0, 0] = 0, 65, 0
    tp = torch.tensor([n_run + 1], dtype=torch.int32)
    off, c1, total = X._expand_inputs(tk.to(dev), ta.to(dev), tp.to(dev))
    run = (off, c1, tb.to(dev), tp.to(dev), total, 1 << 20)
    ms["expand_fused2 distance-1 run 2^20"] = device_ms(lambda: expand2(*run))

    decompress(zs6, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        check(decompress(zs6, device=dev) == data, "zlib -6 did not decode")
    ms["decompress -6 host"] = (time.perf_counter() - t0) / 3 * 1e3
    return ms


def measure(root: str, only: str | None) -> dict:
    # the root's package, not this file's directory, which Python puts first
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch

    from tpu_deflate_torch.kernels import build

    build.library()
    dev = torch.device("cuda", 0)
    with open(CORPUS, "rb") as f:
        data = gzip.decompress(f.read())
    while len(data) < SIZE:
        data += data
    data = data[:SIZE]
    ms = {}
    if only in (None, "encode"):
        ms.update(encode_ms(data, dev))
    if only in (None, "decode"):
        ms.update(decode_ms(data, dev))
    return ms


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "--one":
        only = None if argv[1] == "all" else argv[1]
        print(json.dumps({"root": argv[2],
                          "ms": measure(os.path.abspath(argv[2]), only)}), flush=True)
        return 0
    only = "all"
    if len(argv) >= 2 and argv[0] == "--only" and argv[1] in ("encode", "decode"):
        only, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for root in argv:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                              only, root], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print("measurement | " + " | ".join(r["root"] for r in runs))
    keys = dict.fromkeys(k for r in runs for k in r["ms"])
    for key in keys:
        print(f"{key} | " + " | ".join(
            f"{r['ms'][key]:.4f}" if key in r["ms"] else "-" for r in runs))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
