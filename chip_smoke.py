#!/usr/bin/env python3
"""Smoke run of tpu_deflate_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device  — require a CUDA card; print nvidia-smi's name and power limit
  2. build   — compile the kernels in tpu_deflate_torch/csrc with nvcc
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the main path's shapes (128 lanes of 64 KiB chunks of the
               bench corpus), exact equality; CUDA-event times of both
  4. main    — 8 MiB of tests/data/corpus.bin.gz through compress_indexed
               and decompress_indexed with DEFAULT; stock zlib checks the
               stream; every kernel must have launched
  5. stored  — the same with 256 KiB of seeded random bytes spliced in,
               so stored lanes go through the tokenizer and the expander
  6. dynamic — the 8 MiB through compress_indexed and decompress_indexed
               with dynamic trees (window 256, max_match 10); the stream's
               length and sha256 must equal the JAX package's, pinned
               below, and zlib must read it; every kernel of the path must
               have launched; then a mixed batch of dynamic, stored and
               short-code lanes, and lanes of a stored block followed by a
               dynamic one
Phase 3 also checks the dynamic path's two kernels on its 128 lanes.  The
line before the last is {"kernels": [...]}, each kernel's launches counted
on its own path (4 or 6); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gzip
import hashlib
import itertools
import json
import os
import subprocess
import sys
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(REPO, "tests", "data", "corpus.bin.gz")
CORPUS_SHA = "849e6293c67ab78bf5854ce09a7b27168557ca47b4e2603a50ef6c129f363d41"
SIZE = 8 << 20
SEED = 1951
# the JAX package's compress_indexed of the 8 MiB above (tpu_deflate on
# the CPU): (length, sha256) with DEFAULT and with dynamic trees
PIN_STATIC = (4869675,
              "9db8f28dac24c06f49303b3b97b33c2d28972cda04a0caa3bc00ed46e2cef786")
PIN_DYNAMIC = (3695814,
               "b9db8274d7ff8988ce18f8e79e3e8dd2d814da3f09b9d8f016a8383b13ae0faa")


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def log(*a) -> None:
    print(*a, flush=True)


def load_corpus(size: int) -> bytes:
    with open(CORPUS, "rb") as f:
        data = gzip.decompress(f.read())
    require(hashlib.sha256(data).hexdigest() == CORPUS_SHA, "corpus corrupt")
    while len(data) < size:
        data += data
    return data[:size]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs after one warm-up, by CUDA
    events around the whole run."""
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


def max_abs_err(got, want) -> int:
    require(len(got) == len(want), "output arity differs")
    err = 0
    for g, w in zip(got, want):
        require(g.shape == w.shape, f"shape {tuple(g.shape)} vs {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def require_pinned(stream: bytes, pin, what: str) -> None:
    got = (len(stream), hashlib.sha256(stream).hexdigest())
    require(got == pin, f"{what} stream {got} differs from the JAX package's {pin}")


def capture(module, name: str, calls: list):
    """Replace module.name by a wrapper that records each call's args in
    calls; returns the original, to be put back."""
    fn = getattr(module, name)

    def wrapper(*args):
        calls.append(args)
        return fn(*args)

    setattr(module, name, wrapper)
    return fn


def main() -> None:
    import torch

    require(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, REPO)
    from tpu_deflate_torch import (
        DEFAULT,
        DeflateConfig,
        compress_indexed,
        decompress_indexed,
    )
    from tpu_deflate_torch.kernels import build
    from tpu_deflate_torch.kernels.expand3 import expand_fused3, expand_fused3_plain
    from tpu_deflate_torch.kernels.match2 import (
        match_bitplane_batch,
        match_bitplane_plain,
    )
    from tpu_deflate_torch.kernels.monotone import (
        mono_compact,
        mono_compact_plain,
        mono_scatter_add,
        mono_scatter_add_plain,
    )
    from tpu_deflate_torch.kernels.tokenize import (
        tokenize_static_batch,
        tokenize_static_plain,
    )
    from tpu_deflate_torch.kernels.tokenize_dyn import (
        tokenize_dyn_batch,
        tokenize_dyn_plain,
    )
    from tpu_deflate_torch.ops import decode as D
    from tpu_deflate_torch.ops import encode as E

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    dev = torch.device("cuda", 0)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({build.library_path().name})")

    # ---- 3. kernels against their plain versions ------------------------
    cfg = DEFAULT
    chunk = cfg.chunk_size
    data = load_corpus(SIZE)
    B = SIZE // chunk
    chunks = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    chunks = chunks.reshape(B, chunk).to(dev)
    lens = torch.full((B,), chunk, dtype=torch.int32, device=dev)
    finals = torch.zeros(B, dtype=torch.bool, device=dev)
    finals[-1] = True
    M = E.max_output_bytes(chunk)

    dist, length = match_bitplane_batch(chunks, lens, cfg.window, cfg.max_match)
    vals, nbs, offs, _bits, _ntok = E._encode_emissions(
        chunks, lens, finals, dist, length
    )
    idx, ch = E._bitpack_entries(vals, nbs, offs, E._emission_bits(cfg))
    rows, out_lens, _ = E.encode_blocks_batch(chunks, lens, finals, cfg)
    ends = 8 * out_lens
    tok_cap, pwin = chunk + 16, D.chunk_pwin(chunk)
    tk, ta, tb, tp, *_ = tokenize_static_batch(rows, ends, tok_cap, pwin)
    off, c1, total = D._expand_inputs(tk, ta, tp)

    # the dynamic path's lanes: the same chunks with dynamic trees, their
    # header parse, and the code-length paint's inputs inside it
    dcfg = DeflateConfig(window=256, max_match=10, chunk_size=chunk,
                         dynamic_encode=True)
    drows, dout_lens, _ = E.encode_blocks_batch(chunks, lens, finals, dcfg)
    dends = 8 * dout_lens
    paints = []
    orig = capture(D, "mono_compact", paints)
    prep = D.dyn_header_params_batch(drows, dends)
    D.mono_compact = orig
    coded, starts, status = D.dyn_lanes(prep)
    require(bool(coded.all()), "a corpus lane is stored with dynamic trees on")
    log(f"dynamic trees on {int((prep['btype'] == 2).sum())} of {B} lanes")

    cases = [
        ("match_bitplane_batch", "match2.cu", "tpu_deflate/kernels/match2.py:201",
         match_bitplane_batch, match_bitplane_plain,
         (chunks, lens, cfg.window, cfg.max_match)),
        ("mono_scatter_add", "monotone.cu", "tpu_deflate/kernels/monotone.py:110",
         mono_scatter_add, mono_scatter_add_plain, (idx, ch, M + 8)),
        ("tokenize_static_batch", "tokenize.cu",
         "tpu_deflate/kernels/tokenize.py:469",
         tokenize_static_batch, tokenize_static_plain,
         (rows, ends, tok_cap, pwin)),
        ("expand_fused3", "expand3.cu", "tpu_deflate/kernels/expand3.py:389",
         expand_fused3, expand_fused3_plain,
         (rows, off, c1, tb, tp, total, chunk)),
        ("tokenize_dyn_batch", "tokenize_dyn.cu",
         "tpu_deflate/kernels/tokenize_dyn.py:465",
         tokenize_dyn_batch, tokenize_dyn_plain,
         (drows, dends, prep["tab"], starts, status, torch.zeros_like(starts),
          tok_cap, pwin)),
        ("mono_compact", "monotone.cu", "tpu_deflate/kernels/monotone.py:243",
         mono_compact, mono_compact_plain, paints[0]),
    ]
    results = []
    for kname, src, replaces, kern, plain, args in cases:
        got, want = kern(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"{kname} differs from its plain version by {err}")
        ms = cuda_ms(lambda: kern(*args), reps=10)
        plain_ms = cuda_ms(lambda: plain(*args), reps=2)
        log(f"kernel {kname}: equal to plain on {B} lanes; {ms:.3f} ms "
            f"(plain {plain_ms:.3f} ms) on {name}, {smi}")
        results.append(dict(
            name=kname, route="cuda", source=f"tpu_deflate_torch/csrc/{src}",
            replaces=replaces, fn=kern, max_abs_err=err, ms=ms,
            plain_ms=plain_ms,
        ))

    # ---- 4. the main path -----------------------------------------------
    static_path = results[:4]
    for r in results:
        r["fn"].launches = 0
    t0 = time.perf_counter()
    stream, index = compress_indexed(data, cfg, device=dev)
    t1 = time.perf_counter()
    back = decompress_indexed(stream, index, cfg, device=dev)
    t2 = time.perf_counter()
    for r in static_path:
        r["launches"] = r["fn"].launches
    require(zlib.decompress(stream) == data, "zlib rejects the port's stream")
    require(back == data, "decompress_indexed did not return the input")
    require_pinned(stream, PIN_STATIC, "DEFAULT")
    for r in static_path:
        require(r["launches"] > 0, f"{r['name']} never launched on the main path")
    log(f"main path: {len(data)} B -> {len(stream)} B "
        f"(ratio {len(stream) / len(data):.4f}), zlib verified, equal to "
        f"the JAX package's stream; "
        f"compress_indexed {len(data) / (t1 - t0) / 1e9:.4f} GB/s, "
        f"decompress_indexed {len(data) / (t2 - t1) / 1e9:.4f} GB/s "
        f"(first call, host clock) on {name}, {smi}")
    enc_ms = cuda_ms(lambda: E.encode_blocks_batch(chunks, lens, finals, cfg), 5)
    dec_ms = cuda_ms(
        lambda: D.decode_rows_batch(rows, ends, out_cap=chunk, tok_cap=tok_cap), 5
    )
    api_s = time.perf_counter()
    for _ in range(3):
        decompress_indexed(*compress_indexed(data, cfg, device=dev), cfg,
                              device=dev)
    api_s = (time.perf_counter() - api_s) / 3
    log(f"device encode_blocks_batch {enc_ms:.3f} ms = "
        f"{SIZE / enc_ms / 1e6:.4f} GB/s; decode_rows_batch {dec_ms:.3f} ms = "
        f"{SIZE / dec_ms / 1e6:.4f} GB/s; API round trip {api_s * 1e3:.1f} ms "
        f"on {name}, {smi}")

    # ---- 5. stored lanes ------------------------------------------------
    rng = torch.Generator().manual_seed(SEED)
    noise = torch.randint(0, 256, (256 << 10,), generator=rng, dtype=torch.uint8)
    mixed = data[: 1 << 20] + bytes(noise.numpy()) + data[1 << 20 : 2 << 20]
    stream2, index2 = compress_indexed(mixed, cfg, device=dev)
    stored = int((index2 == chunk + 10).sum())  # two stored blocks per chunk
    require(stored >= 3, f"only {stored} stored lanes in the mixed input")
    require(zlib.decompress(stream2) == mixed, "zlib rejects the mixed stream")
    require(decompress_indexed(stream2, index2, cfg, device=dev) == mixed,
            "mixed input did not round-trip")
    log(f"stored lanes: {stored} of {len(index2)} lanes stored, round trip ok")

    # ---- 6. dynamic trees -----------------------------------------------
    dyn_path = ("match_bitplane_batch", "mono_scatter_add", "mono_compact",
                "tokenize_dyn_batch", "expand_fused3")
    for r in results:
        r["fn"].launches = 0
    t0 = time.perf_counter()
    dstream, dindex = compress_indexed(data, dcfg, device=dev)
    t1 = time.perf_counter()
    dback = decompress_indexed(dstream, dindex, dcfg, device=dev)
    t2 = time.perf_counter()
    counts = {r["name"]: r["fn"].launches for r in results}
    for r in results[4:]:
        r["launches"] = counts[r["name"]]
    require(zlib.decompress(dstream) == data, "zlib rejects the dynamic stream")
    require(dback == data, "the dynamic stream did not round-trip")
    require_pinned(dstream, PIN_DYNAMIC, "dynamic")
    for kname in dyn_path:
        require(counts[kname] > 0, f"{kname} never launched on the dynamic path")
    log(f"dynamic path: {len(data)} B -> {len(dstream)} B "
        f"(ratio {len(dstream) / len(data):.4f}), zlib verified, equal to "
        f"the JAX package's stream; launches {counts}; "
        f"compress_indexed {len(data) / (t1 - t0) / 1e9:.4f} GB/s, "
        f"decompress_indexed {len(data) / (t2 - t1) / 1e9:.4f} GB/s "
        f"(first call, host clock) on {name}, {smi}")
    denc_ms = cuda_ms(lambda: E.encode_blocks_batch(chunks, lens, finals, dcfg), 5)
    ddec_ms = cuda_ms(lambda: D.decode_rows_batch(
        drows, dends, out_cap=chunk, tok_cap=tok_cap, static_only=False), 5)
    prep_ms = cuda_ms(lambda: D.dyn_header_params_batch(drows, dends), 5)
    dtok = D.tokenize_rows_batch(drows, dends, tok_cap, pwin, static_only=False)
    tok_ms = cuda_ms(lambda: D.tokenize_rows_batch(
        drows, dends, tok_cap, pwin, static_only=False), 5)
    exp_ms = cuda_ms(lambda: D.expand_batch(drows, *dtok[:4], chunk), 5)
    api_s = time.perf_counter()
    for _ in range(3):
        decompress_indexed(*compress_indexed(data, dcfg, device=dev), dcfg,
                           device=dev)
    api_s = (time.perf_counter() - api_s) / 3
    log(f"dynamic: device encode_blocks_batch {denc_ms:.3f} ms = "
        f"{SIZE / denc_ms / 1e6:.4f} GB/s; decode_rows_batch(static_only="
        f"False) {ddec_ms:.3f} ms = {SIZE / ddec_ms / 1e6:.4f} GB/s "
        f"(stages alone: tokenize_rows_batch {tok_ms:.3f} ms, of which the "
        f"header prep {prep_ms:.3f} ms alone; expand {exp_ms:.3f} ms); API "
        f"round trip {api_s * 1e3:.1f} ms on {name}, {smi}")

    # stored, short-code and dynamic lanes in one decode call
    zed = b"z" * chunk
    mixed3 = data[: 1 << 20] + bytes(noise.numpy()) + zed + data[1 << 20 : 2 << 20]
    stream3, index3 = compress_indexed(mixed3, dcfg, device=dev)
    require(zlib.decompress(stream3) == mixed3, "zlib rejects the mixed dynamic stream")
    body = stream3[2:-4]
    offs = [0, *itertools.accumulate(int(n) for n in index3)]
    btypes = [(body[o] >> 1) & 3 for o in offs[:-1]]
    mrows = torch.zeros(len(index3), int(index3.max()), dtype=torch.uint8)
    for i in range(len(index3)):
        mrows[i, : index3[i]] = torch.frombuffer(
            bytearray(body[offs[i] : offs[i + 1]]), dtype=torch.uint8)
    mprep = D.dyn_header_params_batch(
        mrows.to(dev), torch.as_tensor(8 * index3, dtype=torch.int32, device=dev))
    short = int(((mprep["btype"] == 2) & (mprep["min_len"] < 3)).sum())
    kinds = {k: btypes.count(k) for k in (0, 1, 2)}
    require(kinds[0] >= 3 and kinds[2] >= 3 and short >= 1,
            f"mixed lanes {kinds}, {short} short-code")
    require(decompress_indexed(stream3, index3, dcfg, device=dev) == mixed3,
            "the mixed dynamic input did not round-trip")
    log(f"mixed dynamic batch: {len(index3)} lanes, block types {kinds}, "
        f"{short} dynamic with codes < 3 bits, round trip ok")

    # a stored block, then a dynamic block whose matches may reach into it,
    # in one lane: the static kernel reads the first, the dynamic kernel
    # goes on from its output
    head, tail = data[:700], data[5000:45000]
    lanes, want = [], []
    for zdict in ({"zdict": head}, {}):
        co = zlib.compressobj(9, zlib.DEFLATED, -15, **zdict)
        lanes.append(bytes([0]) + len(head).to_bytes(2, "little")
                     + (len(head) ^ 0xFFFF).to_bytes(2, "little") + head
                     + co.compress(tail) + co.flush())
        want.append(zlib.decompressobj(-15).decompress(lanes[-1]))
    srows = torch.zeros(len(lanes), max(map(len, lanes)), dtype=torch.uint8)
    for i, lane in enumerate(lanes):
        srows[i, : len(lane)] = torch.frombuffer(bytearray(lane), dtype=torch.uint8)
    sends = torch.tensor([8 * len(lane) for lane in lanes], dtype=torch.int32)
    before = tokenize_dyn_batch.launches
    sout, stot, serr = D.decode_rows_batch(
        srows.to(dev), sends.to(dev), out_cap=chunk, tok_cap=tok_cap,
        static_only=False)
    require(tokenize_dyn_batch.launches > before, "no dynamic kernel launch")
    for i, w in enumerate(want):
        require(int(serr[i]) == 0 and sout[i, : int(stot[i])].cpu().numpy()
                .tobytes() == w, f"stored-then-dynamic lane {i} differs from zlib")
    log(f"stored then dynamic: {len(lanes)} lanes equal to zlib")

    for r in results:
        r.pop("fn")
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
