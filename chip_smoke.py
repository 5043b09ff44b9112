#!/usr/bin/env python3
"""Smoke run of tpu_deflate_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device  — require a CUDA card; print nvidia-smi's name and power limit
  2. build   — compile the kernels in tpu_deflate_torch/csrc with nvcc
  3. kernels — each kernel against its plain PyTorch version on the card,
               at its path's shapes (128 lanes of 64 KiB chunks of the
               bench corpus; for resolve_roots and expand_fused2 one
               segment of a single stream, taken from decompress of zlib
               streams, then long rows with a distance-1 run and
               distances up to 32768; for the device-paced decode's three
               kernels a header, a block's transfer maps and a block of
               the zlib -6 stream, taken from its decompress), exact
               equality; CUDA-event times of both and of the one PyTorch
               call that computes the same function, where there is one
               (host-paced: back-to-back calls of the Python wrapper), and
               the device time of the kernel and of that call (the
               profiler's time of all they launch); the least time the
               card could take, from the bytes and operations of this
               run's inputs, and for the chases also their chain of
               dependent steps; then the static tokenizer on error lanes
               built here (stored, empty, cut, corrupt, dynamic, type 3, a
               distance too far, a lane over a small token capacity), at
               passes of 1088 bits and as whole streams, all seven outputs
               equal to plain; the dynamic tokenizer on its own error
               lanes (zlib at levels 1, 6 and 9, a 1-bit code, 48-bit
               symbols, a distance too far, a bad code, a cut stream, a
               failed header, each also resumed after earlier tokens and
               output) at passes of 1088 bits, at a small token capacity
               and into the caller's buffers, and on calls of the general
               pipeline with one lane; both expanders where matches reach
               before the row, and expand_fused3 on a distance-1 run of
               64 KiB, a stored token of the whole row and rows of 4096
               bytes; match2 on 8 MiB of random bytes and of zeros, and on
               lanes cut short at (window, max_match) (1, 3), (100, 10) and
               (256, 258); the exact far matcher (FULL_WINDOW's) on the
               corpus at window 1024, on 8 MiB of random bytes and of
               zeros and on one row of 1 MiB, each timed beside its plain
               version, on the same short lanes at (300, 12), (1024, 258)
               and (32768, 258), and its launches and the match stage's
               (at most 40); the dynamic trees (dyn_trees_batch) on
               FULL_WINDOW's 128 corpus lanes and, one by one and as one
               batch, on the hand-built lanes of tpu_deflate_torch/lanes.py
               (no token, one literal, literals alone, the repair's 48
               rounds run out, a clipped code-length tree, a tie with the
               static trees), with the plain version's device time and
               FULL_WINDOW's emit stage's launches; the bit-pack on the
               dynamic path's entries, on
               the encoder's entries over zeros at max_match 258, on
               seeded edge lanes (dead head and tail, no live entry, runs
               over slabs), on the main path's batch with its last lane
               and with every lane cut to N / 8 and on the call of a
               one_block compress of 1.125 MiB (runs over most of a lane,
               timed), and its launches (its two kernels, no memset);
               expand_fused2 on every segment and ent_from_phi on every
               block's maps of the -6 and stored-mix -6 decodes, then on
               edge lanes (tpu_deflate_torch.lanes: a match across a tile,
               a tile copied whole from the one before, sources 32768
               back and before the row, distance 0, no token, a total
               and a row that are no tile multiple) and edge maps (T = 32,
               256, 8192; orbits that stop in the first and the last tile,
               entries of 64..190 and 192..255; p0 = 0, 5, 63, 64);
               visited_from_adv on every header and tokenize_dyn_hier on
               every block of those decodes, then on edge lanes
               (tpu_deflate_torch.lanes: the end-of-block in the last tile
               of the walk's second run, the end bit on a chunk boundary,
               a bad code and distances one too far and exactly as far as
               the output in the second run, empty lanes) and edge chases
               (p0 = 63, a terminator at p0, an orbit to the last
               position, T = 256, jumps of 1..64); tokenize_dyn_hier's
               K1d (hier_maps: the candidates' plane and the transfer
               maps) on every block of those decodes and on edge lanes
               (lanes.hier_edge_streams, lanes.k1d_edge_lanes: a 1-bit
               code, end-of-blocks at phases 0 and 63, 48-bit symbols,
               end bits inside a tile and on a block boundary);
               resolve_roots on every segment of the stored-mix decode, on
               edge forests (lanes.resolve_edge_forests: parents after
               their positions, a chain zigzagging across 16 tiles, three
               rows of no tile multiple, rows of one position), and on the
               distance-1 run of a segment, timed, and its launches (two a
               call, no memset, no host read); and expand_fused2 timed on a
               distance-1 run of 1 MiB, with the longest chase across tiles
               its data needs as a second bound (also for resolve_roots).
               Before all of these, the process's first expansion:
               decompress of a stream of 12000 bytes, one row of 16384
  4. main    — 8 MiB of tests/data/corpus.bin.gz through compress_indexed
               and decompress_indexed with DEFAULT; stock zlib checks the
               stream; every kernel must have launched; the device time of
               the encode and the decode and their splits by kernel
  5. stored  — the same with 256 KiB of seeded random bytes spliced in,
               so stored lanes go through the tokenizer and the expander
  6. dynamic — the 8 MiB through compress_indexed and decompress_indexed
               with dynamic trees (window 256, max_match 10); the stream's
               length and sha256 must equal the JAX package's, pinned
               below, and zlib must read it; every kernel of the path must
               have launched; then a mixed batch of dynamic, stored and
               short-code lanes, and lanes of a stored block followed by a
               dynamic one
  7. stream  — the general pipeline of one zlib stream, as one lane
               (ops.decode._inflate_general): zlib -6 of the 8 MiB, then
               the stored-mix input at level 6, each a counted run of its
               own; where the time of the -6 stream goes
  7b. foreign — decompress of one zlib stream on the card, which takes the
               device-paced decode (ops.foreign): zlib -6 of the 8 MiB and
               the stored-mix input at levels 6 and 0, each a counted run
               of its own; outside the counts the port's own static
               stream (also with dynamic=False, which takes the general
               pipeline) and dynamic stream without their index, a
               Z_HUFFMAN_ONLY stream with a 1-bit literal code, whose
               blocks the lane tokenizer walks within the device-paced
               decode, and a corrupt stream,
               which must raise DeflateError; where the time of the -6
               stream goes
  8. long rows — the 8 MiB as 8 chunks of 1 MiB through compress_indexed
               and decompress_indexed, a counted run; zlib reads the
               stream; each kernel call of that run again, on the same
               arguments, against its plain version
  9. gzip and streaming — four counted runs: compress_gzip_members of
               the 8 MiB with DEFAULT, then decompress_gzip of it (the
               members as lanes); decompress_gzip of gzip -6 of the 8 MiB
               and of 8 gzip -6 members of 1 MiB (the device-paced decode
               from each member's body); StreamDecompressor over zlib -6
               of the 8 MiB in 64 KiB slices (a stream step a Huffman
               block, with a 32 KiB window after the first).  Each result
               must equal the input, gzip must read the members, and
               they must equal the JAX package's, pinned below; the first
               call of each kernel in each run (the first two in the
               stream run) is held against its plain version; every kernel
               but the exact far matcher must launch across the four runs,
               and it must not; the host-clock
               median and spread of three runs of each decode and the
               number of stream steps are logged.  Outside the counts:
               StreamDecompressor over the port's own stream and over
               zlib -6 of 1 MiB in 4 KiB slices, StreamCompressor of the
               8 MiB in slices of 1000003 bytes (pinned), compress_gzip
               (its body the pinned DEFAULT stream's), gzip members with
               FNAME, FCOMMENT, FEXTRA and FHCRC, and a member that falls
               back (a 1-bit literal code)
  10. full window — three counted runs of the 8 MiB through
               compress_indexed and decompress_indexed with window 32768,
               max_match 258 and the lazy parse: FULL_WINDOW (the exact
               far matcher, dynamic trees, 64 KiB chunks), bench.py's
               speed configuration (the fast far matcher, static trees)
               and its best-ratio one (exact, dynamic, 256 KiB chunks,
               whose rows take expand_fused2).  Each stream must equal
               the JAX package's, pinned below, zlib must read it and the
               decode must return the input; the first call of each
               kernel is held against its plain version; the ratio
               against zlib -6 and the encode's GB/s by CUDA events and
               by the profiler, split into the match stage (its own
               profiled run: the far matcher's kernels and sort, or the
               fast one's glue), the bit-pack and the rest, are logged;
               the exact far matcher must launch in the exact runs and
               not in the fast one.
               FULL_WINDOW's stream also decodes through decompress (the
               device-paced decode).  Outside the counts: run_selftest on
               the card, the CLI at levels fast, ref and max (zlib, gzip,
               -d; python -m tpu_deflate_torch in a process of its own)
               on 1 MiB, checked by zlib and gzip, Profiler around a
               FULL_WINDOW compress and decompress, and device_trace
               around the compress
  11. sharding — one rank a visible card, each a process of its own
               (this script with --shard-rank), joined by NCCL through
               the JAX package's launch variables on a free port and
               joined back with a time limit (a rank that fails fails the
               phase with its exit code and stderr).  Each rank takes its
               chunks of the 8 MiB (host_shard_bounds, make_global_batch)
               through encode_sharded and assemble_ragged, the bodies are
               gathered, and decode_sharded must return its input with no
               error; rank 0 checks the stream with zlib, against
               PIN_STATIC (DEFAULT), PIN_DYNAMIC (dynamic trees) and, at
               1 MiB chunks (rows taken by expand_fused2), against
               compress's stream.  Three counted runs a rank, the first
               call of each kernel held against its plain version; the
               host-clock median and spread of 3 and the encode's and the
               decode's device time by the profiler are logged.  In this
               process: a mesh that lists the card four times gives the
               DEFAULT stream again and decodes it (a counted run), every
               Huffman lane 3 bits into its byte decodes as at bit 0
               (outside the counts), and dryrun_multichip over every card
               (a counted run).  With one card the collective spans one
               rank: the exchange across ranks is checked by
               tests/test_torch_multihost.py's two gloo processes
Phase 3 also checks the dynamic path's two kernels on its 128 lanes.
Every launch count is set to 0 just before each counted run (phases 4 and
6, the two of 7, the three of 7b, 8, the four of 9, the three of 10 and
the five of 11, whose rank runs sum over the ranks) and read just after
it.  The
line before the last is {"kernels": [...]}: "launches_by_path" holds each
kernel's count in each of those runs and "launches" the count on the path
that brought the kernel in (OWN_PATH); the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import gzip
import hashlib
import itertools
import json
import os
import shutil
import socket
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
# and with DEFAULT its compress_gzip_members, and its StreamCompressor fed
# slices of 1000003 bytes
PIN_GZIP_MEMBERS = (4872694,
                    "a9953cb5ad6fc76ce0b76a59dd51b8a2ed2212d965a74d0c1391d2357779ed64")
PIN_STREAM = (4869681,
              "a398e34cf515c19af63f6b5fe883d63a6d14788119a56776f64422851fead78d")
# and its compress_indexed with FULL_WINDOW, with bench.py's speed
# configuration of the full window (the fast far matcher, static trees) and
# with its best-ratio one (256 KiB chunks), encoded 8 and 2 lanes at a time
PIN_FULL_WINDOW = (2002794,
                   "a108ed0d08828fb7b21d609b6738d862db4412d18c83890aa6bd12635515154d")
PIN_FULL_FAST = (2572496,
                 "99c0f54c2c6cd409043a5be5f9d756d4ff3a63ab0a77105464b0f52bed567be9")
PIN_BEST_RATIO = (1885997,
                  "cc7dd505f4ef1b4c2becf96780e3960cb8e4bd66a2934d6ec7571d0cd79882af")


# NVIDIA's data sheet for the H100 SXM: device memory rate, and the float32
# rate outside the tensor cores, to which the kernels' integer work is held
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
SYMBOL_OPS = 32  # integer operations to decode one symbol, about
# a chase's second bound: a chain of dependent steps, each at least one
# read of shared memory (about 20 cycles) at the data sheet's boost clock.
# The two tokenizers have no such chain: their blocks find the symbol
# starts of a window in parallel, so their bound is bytes alone.
SM_HZ = 1.98e9
STEP_CYCLES = 20
# a step of expand_fused2's chase is a read through L2, taken here as 300
# cycles (an assumption, not a measurement)
L2_CYCLES = 300

# the counted run whose count is a kernel's "launches"
OWN_PATH = {
    "match_bitplane_batch": "static", "mono_scatter_add": "static",
    "tokenize_static_batch": "static", "expand_fused3": "static",
    "tokenize_dyn_batch": "dynamic", "mono_compact": "dynamic",
    "expand_fused2": "stream", "resolve_roots": "stream_stored_mix",
    "ent_from_phi": "foreign", "visited_from_adv": "foreign",
    "tokenize_dyn_hier": "foreign", "far_match_batch": "full_window",
    "dyn_trees_batch": "dynamic",
}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate."""
    by_bytes, by_ops = moved / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


# What each kernel must move and do for one call: (bytes, operations) from
# its arguments and results, counting what the data needs (live tokens, the
# bits consumed, the distances searched), each byte once.
def work_match(args, outs):
    chunks, lens, window, _ = args
    dist, length = outs
    searched = int(dist.where(dist > 0, dist.new_tensor(window)).sum())
    return nbytes(chunks, lens, dist, length), searched + int(length.sum())


def work_far(args, outs):
    """Each byte read once and a distance and a length written a position;
    a compare for each of the six candidates and each byte matched."""
    chunks, lens, _, _ = args
    dist, length = outs
    return nbytes(chunks, lens) + 8 * dist.numel(), 6 * dist.numel() + int(length.sum())


def work_trees(args, outs):
    """A start flag a position, the symbols of each token (and the distance
    of each match) read, the tables and header written; an operation a
    token, and a pass over every length at every level of the sweeps."""
    start, lsym, _ = args
    tokens = int(start.sum())
    matches = int((start & (lsym >= 257)).sum())
    return (start.numel() + 8 * (tokens + matches) + nbytes(*outs),
            tokens + matches + start.shape[0] * 316 * 28)


def trees_plain(start, litlen_sym, dsym):
    """``_dynamic_trees_plain`` on the kernel's arguments: a start is a
    match where its symbol is a length code; the extra bits, alike under
    either tree, left out."""
    from tpu_deflate_torch.ops import encode as E

    return E._dynamic_trees_plain(start, start & (litlen_sym >= 257), litlen_sym,
                                  dsym, 0, 0)


def work_scatter(args, outs):
    idx, vals, _ = args
    return nbytes(idx, vals, outs[0]), vals.numel()


def work_tokenize(args, outs, start=0):
    _tk, _ta, _tb, ntok, _total, pos, err = outs
    tokens = int(ntok.sum())
    read = int(((pos - start + 7) // 8).clamp_min(0).sum())
    # the end bit read and four counters written per lane
    return read + 12 * tokens + 20 * ntok.numel(), SYMBOL_OPS * tokens


def work_tokenize_dyn(args, outs):
    _rows, _ends, tab, starts, status, tok0 = args[:6]
    moved, ops = work_tokenize(args, outs, starts)
    # two comparison decodes (literal/length, distance) for a symbol
    return moved + nbytes(tab, starts, status, tok0), 2 * ops


def work_hier(args, outs):
    """The block's bits once, the tables, the tokens: the same as a serial
    decode of it needs."""
    _win, ends, tab, starts, _pw = args
    _tk, _ta, _tb, ntok, _total, pos, _err = outs
    tokens = int(ntok.sum())
    read = int(((pos - starts + 7) // 8).clamp_min(0).sum())
    return (read + 12 * tokens + 16 + nbytes(ends, tab, starts),
            2 * SYMBOL_OPS * tokens)


def work_ent(args, outs):
    """The maps once, one composition step for each phase of each tile."""
    phiP, p0 = args
    return nbytes(phiP, p0, outs[0]), 64 * phiP.shape[2]


def work_visit(args, outs):
    """The jumps and terminators once, one step for each position."""
    return nbytes(*args, outs[0]), outs[0].numel()


def work_expand(tp, total, out):
    return 12 * int(tp.sum()) + nbytes(tp, total, out), int(total.sum())


def work_resolve(args, outs):
    return nbytes(*args, outs[0]), 2 * outs[0].numel()


def expand2_chain(args, tile: int) -> int:
    """The longest chase that expand_fused2's data needs: each byte's parent
    by the kernel's rule, jumped inside its tile of ``tile`` bytes to its
    root there or to the first byte before the tile on its chain; a byte
    of the second kind takes one read through L2 more than that byte."""
    import torch

    off, c1, tb, tp, total, out_cap = args
    B, K = off.shape
    longest = 0
    for b in range(B):
        n, tot = min(max(int(tp[b]), 0), K), min(max(int(total[b]), 0), out_cap)
        if n == 0 or tot == 0:
            continue
        q = torch.arange(tot, device=off.device)
        own = torch.searchsorted(off[b, :n], q.to(off.dtype), right=True) - 1
        m = own.clamp_min(0)
        c, d, o = c1[b, m], tb[b, m].long(), off[b, m].long()
        match = (own >= 0) & (((c >> 9) & 3) == 1) & (d > 0) & (o <= q)
        ref = torch.where(match, (o - d + (q - o) % d.clamp_min(1)).clamp_min(0), q)
        t0 = q // tile * tile
        while True:
            nxt = torch.where(ref >= t0, ref[ref], ref)
            if torch.equal(nxt, ref):
                break
            ref = nxt
        steps = torch.zeros_like(q)
        for j in range(0, tot, tile):  # a tile's chases end in earlier tiles
            r = ref[j : j + tile]
            steps[j : j + tile] = torch.where(r < j, 1 + steps[r], 0)
        longest = max(longest, int(steps.max()))
    return longest


def resolve_chase(args, tile: int) -> int:
    """The longest chase across tiles that resolve_roots' data needs: each
    position's parent jumped inside its tile of ``tile`` positions to its
    root there or to the first position outside the tile on its chain (its
    exit); a position of the second kind takes one read through L2 more
    than its exit.  Counted by doubling (list ranking)."""
    import torch

    parent = args[0].long()
    N = parent.shape[-1]
    at = torch.arange(N, device=parent.device)
    t0 = at // tile * tile
    ref = parent.clamp(0, N - 1)
    while True:
        inside = (ref >= t0) & (ref < t0 + tile)
        nxt = torch.where(inside, torch.gather(ref, -1, ref), ref)
        if torch.equal(nxt, ref):
            break
        ref = nxt
    leaves = ~((ref >= t0) & (ref < t0 + tile))
    nxt = torch.where(leaves, ref, at)
    hops = leaves.long()
    while True:
        n2 = torch.gather(nxt, -1, nxt)
        if torch.equal(n2, nxt):
            return int(hops.max())
        hops = hops + torch.gather(hops, -1, nxt)
        nxt = n2


def jump_depth(hops: int) -> int:
    """The dependent reads through L2 of a chase of ``hops`` steps where the
    chases jump pointers (resolve_roots: each writes the position it
    reached over its own entry): ceil(log2 hops) to reach the root, and one
    more to see that it is one."""
    return 0 if hops == 0 else (hops - 1).bit_length() + 1


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


def device_ops(fn, reps: int) -> list:
    """The device operations of reps calls of fn() after one warm-up, by
    the profiler: kernels, copies, memsets.  The program's spans (``td.*``,
    ``utils/profiling.py``) are left out: the profiler also sets them on
    the device's timeline, as stretches that hold the operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.name.startswith("td.")]


def device_split(fn, reps: int) -> dict:
    """Mean device milliseconds of fn() by kernel name, over reps calls
    after one warm-up: the profiler's time of everything fn launches on
    the card (kernels, copies, memsets)."""
    split = {}
    for e in device_ops(fn, reps):
        split[e.name] = split.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return split


def device_launches(fn, reps: int) -> dict:
    """Device operations a call of fn() by name (kernels, copies,
    memsets), over reps calls after one warm-up."""
    counts = {}
    for e in device_ops(fn, reps):
        counts[e.name] = counts.get(e.name, 0) + 1 / reps
    return counts


def device_ms(fn, reps: int = 10):
    """Mean device milliseconds of fn() (``device_split`` summed), over up
    to three tries: a short profile sometimes comes back without its
    kernels; None where no try saw device time."""
    for _ in range(3):
        total = sum(device_split(fn, reps).values())
        if total > 0:
            return total
    return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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


def error_lanes(data: bytes, torch):
    """(names, rows uint8[L, 4096], end bits int32[L]): raw DEFLATE lanes
    built with zlib and by hand, each ending in one of the static
    tokenizer's outcomes."""

    def raw(payload, level=9, strategy=zlib.Z_DEFAULT_STRATEGY):
        co = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
        return co.compress(payload) + co.flush()

    noise = bytes(torch.randint(0, 256, (900,), dtype=torch.uint8,
                                generator=torch.Generator().manual_seed(SEED)).numpy())
    fixed = raw(data[:2200], strategy=zlib.Z_FIXED)
    text = data[40000:43000]
    lanes = [
        ("static", fixed, None),
        ("static_text", raw(text, strategy=zlib.Z_FIXED), None),
        ("stored", raw(noise, 0), None),
        ("stored_then_static",
         b"\x00" + (5).to_bytes(2, "little") + (5 ^ 0xFFFF).to_bytes(2, "little")
         + b"hello" + fixed, None),
        ("empty", b"", 0),
        ("truncated", fixed, 8 * len(fixed) // 2),
        ("corrupted", bytes(b ^ 0x5A if i % 97 == 50 else b
                            for i, b in enumerate(fixed)), None),
        ("dynamic", raw(text, 9), None),
        # a final static block: literal "A", then length 5 at distance 3
        ("too_far", bytes.fromhex("73042300"), None),
        ("method3", b"\x07\x00", None),
        ("bad_stored", b"\x01\x05\x00\x00\x00hello", None),
        ("eob_only", bytes.fromhex("0300"), None),  # a final static block, empty
    ]
    width = 4096
    rows = torch.zeros(len(lanes), width, dtype=torch.uint8)
    ends = []
    for i, (lname, lane, end) in enumerate(lanes):
        require(len(lane) <= width, f"error lane {lname} too long")
        if lane:
            rows[i, : len(lane)] = torch.frombuffer(bytearray(lane), dtype=torch.uint8)
        ends.append(8 * len(lane) if end is None else end)
    return ([lname for lname, _, _ in lanes], rows,
            torch.tensor(ends, dtype=torch.int32))


def dyn_error_lanes(data: bytes, L):
    """(name, stream, end bit) of lanes that each start with a dynamic
    header and end in one of the dynamic tokenizer's outcomes: zlib blocks
    at levels 1, 6 and 9, a Z_HUFFMAN_ONLY block with a 1-bit literal code,
    a block whose widest symbol is 48 bits (15-bit length and distance
    codes, 5 and 13 extra bits), a distance too far, a bad code, a cut
    stream, a header that fails.  L: the port's lane builders."""

    def raw(payload, level=9, strategy=zlib.Z_DEFAULT_STRATEGY, **kw):
        co = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy, **kw)
        return co.compress(payload) + co.flush()

    text = data[40000:43000]
    skew = bytes(2500) + data[7000:7120]
    zl9 = raw(text, 9)
    cl_oversub = [(1, 1), (2, 2), (0, 5), (0, 5), (15, 4)] + [(1, 3)] * 19
    lanes = [
        ("zlib1", raw(text, 1), None),
        ("zlib6", raw(text, 6), None),
        ("zlib9", zl9, None),
        ("huffman_only", raw(skew, 9, zlib.Z_HUFFMAN_ONLY), None),
        ("wide", L.wide_block(), None),
        ("far", raw(text[300:2300], 9, zdict=text[:300]), None),
        ("bad_code", L.bad_code_block(), None),
        ("truncated", zl9, 4 * len(zl9)),
        ("cl_oversub", L.bits_to_bytes(cl_oversub + [(1, 1)] * 400), None),
    ]
    return [(n, s, 8 * len(s) if e is None else e) for n, s, e in lanes]


def capture(module, name: str, calls: list):
    """Replace module.name by a wrapper that records each call's args in
    calls; returns the original, to be put back."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        calls.append(args)
        return fn(*args, **kw)

    setattr(module, name, wrapper)
    return fn


def clone(x):
    """A copy of x in which every tensor, also inside tuples, lists and
    dicts, is cloned."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(clone(v) for v in x)
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    return x


def capture_first(module, name: str, calls: list, keep: int):
    """Like ``capture``, but records (args, kwargs) cloned as they were
    passed (a kernel may write into its arguments), of the first ``keep``
    calls only."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        if len(calls) < keep:
            calls.append((clone(args), clone(kw)))
        return fn(*args, **kw)

    setattr(module, name, wrapper)
    return fn


# phase 11's runs in each rank: (path, config fields, pinned stream or None
# for the single-process compress's, kernels that must launch)
SHARD_RUNS = (
    ("sharded_static", {}, PIN_STATIC,
     ("match_bitplane_batch", "mono_scatter_add", "tokenize_static_batch",
      "expand_fused3")),
    ("sharded_dynamic", {"dynamic_encode": True}, PIN_DYNAMIC,
     ("match_bitplane_batch", "dyn_trees_batch", "mono_scatter_add", "mono_compact",
      "tokenize_dyn_batch", "expand_fused3")),
    ("sharded_long", {"chunk_size": 1 << 20}, None,
     ("match_bitplane_batch", "mono_scatter_add", "tokenize_static_batch",
      "expand_fused2")),
)


def padded(stream: bytes):
    """The stream zero-padded to a power of two, as a numpy array."""
    import numpy as np

    buf = np.zeros(1 << max(len(stream), 2).bit_length(), np.uint8)
    buf[: len(stream)] = np.frombuffer(stream, np.uint8)
    return buf


def kernel_sites() -> list:
    """(call site's module, name, wrapper, plain version) of every kernel:
    the wrapper carries the launch count, and the port's paths look the
    kernel up in the call site's module, where a capture sees each call."""
    from tpu_deflate_torch.kernels import (
        chase1,
        dyntrees,
        expand2,
        expand3,
        farmatch,
        match2,
    )
    from tpu_deflate_torch.kernels import monotone, resolve, tokenize, tokenize_dyn
    from tpu_deflate_torch.ops import decode as D
    from tpu_deflate_torch.ops import encode as E
    from tpu_deflate_torch.ops import expand as X
    from tpu_deflate_torch.ops import foreign as F
    from tpu_deflate_torch.ops import header as H

    return [
        (E, "match_bitplane_batch", match2.match_bitplane_batch,
         match2.match_bitplane_plain),
        (E, "far_match_batch", farmatch.far_match_batch, E._far_match_plain),
        (E, "dyn_trees_batch", dyntrees.dyn_trees_batch, trees_plain),
        (E, "mono_scatter_add", monotone.mono_scatter_add,
         monotone.mono_scatter_add_plain),
        (H, "mono_compact", monotone.mono_compact, monotone.mono_compact_plain),
        (D, "tokenize_static_batch", tokenize.tokenize_static_batch,
         tokenize.tokenize_static_plain),
        (D, "tokenize_dyn_batch", tokenize_dyn.tokenize_dyn_batch,
         tokenize_dyn.tokenize_dyn_plain),
        (X, "expand_fused3", expand3.expand_fused3, expand3.expand_fused3_plain),
        (X, "resolve_roots", resolve.resolve_roots,
         lambda p, v: resolve.resolve_roots_plain(p.long(), v.long())),
        (X, "expand_fused2", expand2.expand_fused2, expand2.expand_fused2_plain),
        (tokenize_dyn, "ent_from_phi", chase1.ent_from_phi, chase1.ent_from_phi_plain),
        (F, "visited_from_adv", chase1.visited_from_adv,
         chase1.visited_from_adv_plain),
        (F, "tokenize_dyn_hier", tokenize_dyn.tokenize_dyn_hier,
         tokenize_dyn.tokenize_dyn_hier_plain),
    ]


def held_run(path: str, drive, must, keep: int = 1):
    """A counted run: every kernel's count set to 0 just before drive()
    and read just after, the kernels in must required to have launched;
    the first ``keep`` calls of each kernel captured at its call site
    (arguments cloned as passed) and, outside the count, held against its
    plain version.  Returns (drive's result, counts, calls held, host
    seconds of drive)."""
    sites = kernel_sites()
    seen = {f: [] for _, f, _, _ in sites}
    originals = [capture_first(m, f, seen[f], keep) for m, f, _, _ in sites]
    for _, _, fn, _ in sites:
        fn.launches = 0
    try:
        t = time.perf_counter()
        out = drive()
        host = time.perf_counter() - t
    finally:
        for (m, f, _, _), fn in zip(sites, originals):
            setattr(m, f, fn)
    counts = {f: fn.launches for _, f, fn, _ in sites}
    for kname in must:
        require(counts[kname] > 0, f"{kname} never launched on the {path} "
                f"path; counts {counts}")
    held = 0
    for (_, f, _, plain), fn in zip(sites, originals):
        for args, kw in seen[f]:
            got = fn(*clone(args), **clone(kw))
            want = plain(*clone(args), **clone(kw))
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max_abs_err(got, want)
            require(err == 0, f"{f} differs from its plain version on the "
                    f"{path} run by {err}")
            held += 1
    return out, counts, held, host


def shard_rank(rank: int, world: int, port: int, report_path: str) -> None:
    """One rank of phase 11, in a process of its own: join the NCCL group
    through the JAX package's launch variables, then for each of
    SHARD_RUNS materialize this rank's chunks of the 8 MiB
    (host_shard_bounds, make_global_batch), encode them (encode_sharded,
    assemble_ragged), gather the bodies, decode this rank's lanes
    (decode_sharded) and check them against the input; rank 0 checks the
    stream with zlib and against its pin.  Writes counts, calls held and
    times to report_path as JSON."""
    import numpy as np
    import torch
    import torch.distributed as dist

    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{port}",
                      NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
    sys.path.insert(0, REPO)
    from tpu_deflate_torch import DeflateConfig, compress
    from tpu_deflate_torch.parallel import multihost as MH
    from tpu_deflate_torch.parallel.shard import (
        assemble_ragged,
        decode_sharded,
        encode_sharded,
    )

    require(MH.initialize(), "initialize did not join the process group")
    require(dist.get_backend() == "nccl" and dist.get_world_size() == world
            and dist.get_rank() == rank, f"group {dist.get_backend()}, "
            f"{dist.get_world_size()} ranks")
    mesh = MH.global_mesh()
    dev = mesh.devices[0]
    require(mesh.devices == (torch.device("cuda", torch.cuda.current_device()),)
            and mesh.size == world, f"mesh {mesh}")
    name = torch.cuda.get_device_name(dev)
    data = load_corpus(SIZE)
    report = {"rank": rank, "world": world, "device": f"{dev} {name}", "runs": {}}
    for path, fields, pin, must in SHARD_RUNS:
        cfg = DeflateConfig(**fields)
        C = cfg.chunk_size
        n = SIZE // C
        lo, hi = MH.host_shard_bounds(n)
        rows = torch.frombuffer(bytearray(data[lo * C : hi * C]),
                                dtype=torch.uint8).reshape(hi - lo, C)
        lens = torch.full((hi - lo,), C, dtype=torch.int32)
        fins = torch.arange(lo, hi) == n - 1

        def encode():
            g = [MH.make_global_batch(x, n, mesh) for x in (rows, lens, fins)]
            out, sizes, adler = encode_sharded(*g, mesh, cfg)
            body, total = assemble_ragged(out, sizes, out.numel())
            return body, total, sizes, adler

        def decode(body, total, sizes):
            parts = [None] * world
            dist.all_gather_object(parts, (body[: int(total)].cpu().numpy().tobytes(),
                                           sizes.cpu().tolist()))
            whole = b"".join(p[0] for p in parts)
            offs = 8 * np.concatenate([[0], np.cumsum([s for p in parts for s in p[1]])])
            got = decode_sharded(padded(whole), offs[:-1].astype(np.int32),
                                 offs[1:].astype(np.int32), mesh, C,
                                 static_only=not cfg.dynamic_encode)
            torch.cuda.synchronize(dev)
            return whole, got

        def drive():
            body, total, sizes, adler = encode()
            return decode(body, total, sizes) + (int(adler),)

        (whole, (outs, totals, errs), adler), counts, held, first = held_run(
            path, drive, must)
        require(int(errs.ne(0).sum()) == 0, f"{path}: decode errors "
                f"{errs[errs != 0][:8].tolist()}")
        require(bool((totals == C).all()) and torch.equal(outs.cpu(), rows),
                f"{path}: decode_sharded did not return rank {rank}'s input")
        if rank == 0:
            stream = b"\x78\x9c" + whole + adler.to_bytes(4, "big")
            require(zlib.decompress(stream) == data, f"zlib rejects the {path} stream")
            if pin is not None:
                require_pinned(stream, pin, path)
            else:
                require(stream == compress(data, cfg, device=dev),
                        f"{path}: the stream differs from compress's")
        runs = [first]
        for _ in range(2):
            t = time.perf_counter()
            drive()
            runs.append(time.perf_counter() - t)
        enc = device_split(encode, 1)
        body, total, sizes, _ = encode()
        dec = device_split(lambda: decode(body, total, sizes), 1)
        report["runs"][path] = dict(
            counts=counts, held=held, host_s=runs, bytes=len(whole) + 6,
            lanes=hi - lo, encode_device_ms=sum(enc.values()),
            decode_device_ms=sum(dec.values()))
        log(f"rank {rank}: {path} {report['runs'][path]}")
    with open(report_path, "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def run_ranks(world: int, work: str) -> list:
    """Phase 11's ranks, one process a card, on a free port, joined with a
    time limit; a rank that fails fails the phase with its exit code and
    its stderr.  Returns their reports."""
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                        "NUM_PROCESSES", "PROCESS_ID", "LOCAL_RANK")}
    paths = [os.path.join(work, f"rank{r}.json") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-rank", str(r),
         str(world), str(port), paths[r]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            log(f"[rank {r}] {line}")
        require(p.returncode == 0, f"rank {r} of {world} failed with exit code "
                f"{p.returncode}: {err[-4000:]}")
    reports = []
    for path in paths:
        with open(path) as f:
            reports.append(json.load(f))
    return reports


def main() -> None:
    import torch

    require(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, REPO)
    from tpu_deflate_torch import (
        DEFAULT,
        FULL_WINDOW,
        DeflateConfig,
        DeflateError,
        StreamCompressor,
        StreamDecompressor,
        compress,
        compress_gzip,
        compress_gzip_members,
        compress_indexed,
        decompress,
        decompress_gzip,
        decompress_indexed,
    )
    from tpu_deflate_torch import api as A
    from tpu_deflate_torch.cli import main as cli_main
    from tpu_deflate_torch.kernels import build
    from tpu_deflate_torch.kernels import tokenize_dyn as KD
    from tpu_deflate_torch.kernels.chase1 import (
        ent_from_phi,
        ent_from_phi_plain,
        visited_from_adv,
        visited_from_adv_plain,
    )
    from tpu_deflate_torch.kernels.expand2 import TILE as E2_TILE
    from tpu_deflate_torch.kernels.expand2 import expand_fused2, expand_fused2_plain
    from tpu_deflate_torch.kernels.expand3 import expand_fused3, expand_fused3_plain
    from tpu_deflate_torch.kernels.dyntrees import dyn_trees_batch
    from tpu_deflate_torch.kernels.farmatch import far_match_batch
    from tpu_deflate_torch.kernels.match2 import (
        match_bitplane_batch,
        match_bitplane_plain,
    )
    from tpu_deflate_torch.kernels.resolve import TILE as RES_TILE
    from tpu_deflate_torch.kernels.resolve import resolve_roots, resolve_roots_plain
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
        hier_maps,
        hier_maps_plain,
        tokenize_dyn_batch,
        tokenize_dyn_hier,
        tokenize_dyn_hier_plain,
        tokenize_dyn_plain,
    )
    from tpu_deflate_torch.ops import decode as D
    from tpu_deflate_torch.ops import encode as E
    from tpu_deflate_torch.ops import expand as X
    from tpu_deflate_torch.ops import foreign as F
    from tpu_deflate_torch.ops import header as H
    from tpu_deflate_torch.selftest import run_selftest
    from tpu_deflate_torch.utils.profiling import Profiler, device_trace

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
    # the process's first expansion, at a row whose shared memory fits
    # only with the opt-in (3 * 16384 bytes beside the kernel's static
    # queue): decompress of a stream of 12000 bytes expands one row of 16384
    first3 = []
    orig = capture(X, "expand_fused3", first3)
    small = data[:12000]
    require(decompress(zlib.compress(small, 6), device=dev) == small,
            "a stream of 12000 bytes did not decode")
    X.expand_fused3 = orig
    require(len(first3) == 1 and first3[0][6] == 1 << 14,
            f"{len(first3)} first expansions, rows {[a[6] for a in first3]}")
    require(torch.equal(expand_fused3(*first3[0]), expand_fused3_plain(*first3[0])),
            "expand_fused3 differs from plain on its first row, of 16384 bytes")
    log("kernel expand_fused3: its first launch, a row of 16384 bytes in "
        "decompress, equal to plain")
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
    off, c1, total = X._expand_inputs(tk, ta, tp)

    # the dynamic path's lanes: the same chunks with dynamic trees, their
    # header parse, and the code-length paint's inputs inside it
    dcfg = DeflateConfig(window=256, max_match=10, chunk_size=chunk,
                         dynamic_encode=True)
    drows, dout_lens, _ = E.encode_blocks_batch(chunks, lens, finals, dcfg)
    dends = 8 * dout_lens
    paints = []
    orig = capture(H, "mono_compact", paints)
    prep = D.dyn_header_params_batch(drows, dends)
    H.mono_compact = orig
    coded, starts, status = D.dyn_lanes(prep)
    require(bool(coded.all()), "a corpus lane is stored with dynamic trees on")
    log(f"dynamic trees on {int((prep['btype'] == 2).sum())} of {B} lanes")

    # the single stream's lanes: one segment of zlib -6 of the 8 MiB, with
    # distances up to 32768, as decompress hands it to expand_fused2, and
    # one segment with stored tokens (the stored-mix input, below) as it
    # hands it to resolve_roots
    zs6 = zlib.compress(data, 6)
    rng = torch.Generator().manual_seed(SEED)
    noise = torch.randint(0, 256, (256 << 10,), generator=rng, dtype=torch.uint8)
    mixed = data[: 1 << 20] + bytes(noise.numpy()) + data[1 << 20 : 2 << 20]
    zmix6 = zlib.compress(mixed, 6)
    # the device-paced decode's kernels on the -6 stream: its headers'
    # code-length chases, its blocks' transfer maps and its blocks
    segs, chains, visits, maps, blocks_in = [], [], [], [], []
    patched = [(X, "expand_fused2", segs), (X, "resolve_roots", chains),
               (F, "visited_from_adv", visits), (KD, "ent_from_phi", maps),
               (F, "tokenize_dyn_hier", blocks_in)]
    originals = [capture(m, f, calls) for m, f, calls in patched]
    # on the card a header's parse is a graph replay, whose launches no
    # wrapper sees: here each header runs its ops one by one instead
    replayed = F._header_graph
    F._header_graph = lambda _dev: lambda up, clw: F._dynamic_header(
        torch.from_numpy(up).to(dev), clw)
    require(decompress(zs6, device=dev) == data, "zlib -6 stream did not decode")
    n6, v6 = len(blocks_in), len(visits)
    require(decompress(zmix6, device=dev) == mixed, "stored-mix -6 did not decode")
    F._header_graph = replayed
    for (m, f, _), fn in zip(patched, originals):
        setattr(m, f, fn)
    require(len(segs) >= 16 and len(chains) >= 1,
            f"{len(segs)} expand_fused2 and {len(chains)} resolve_roots calls")
    require(v6 >= 10 and len(maps) == len(blocks_in) and n6 >= v6,
            f"{v6} headers, {len(maps)} maps, {n6} blocks")
    mid = n6 // 3  # a full block of the -6 stream
    require(maps[mid][0].shape == (1, 16, 8192) and blocks_in[mid][4] == F.PW,
            f"maps {tuple(maps[mid][0].shape)}, window {blocks_in[mid][4]}")
    seg = segs[1]  # a full segment behind a 32 KiB window of real output
    seg_live = seg[2][0, : int(seg[3][0])]
    require(seg[5] == F.SEG_CAP and int(seg_live.max()) > 2048,
            f"segment row {seg[5]}, largest distance {int(seg_live.max())}")
    chain = max(chains, key=lambda a: int((a[0] != torch.arange(
        a[0].shape[1], device=dev)).sum()))  # the one with most match bytes
    require(chain[0].shape == (1, F.SEG_CAP), f"resolve row {chain[0].shape}")

    def scatter_library(idx, vals, size):
        """The same sums by one ``Tensor.scatter_add_``; entries that drop
        out go to a spare last column."""
        Bq, C, K = vals.shape
        tgt = torch.where((idx < 0) | (idx >= size), size, idx).to(torch.int64)
        tgt = tgt[:, None, :].expand(Bq, C, K).contiguous()

        def call():
            out = torch.zeros(Bq, C, size + 1, dtype=torch.int32, device=dev)
            return out.scatter_add_(2, tgt, vals)[:, :, :size]

        return call

    # the dynamic trees' arguments in FULL_WINDOW's encode of the 8 MiB
    trees_in = []
    orig = capture(E, "dyn_trees_batch", trees_in)
    E.encode_blocks_batch(chunks, lens, finals, FULL_WINDOW)
    E.dyn_trees_batch = orig
    require(len(trees_in) == 1 and trees_in[0][0].shape == (B, chunk),
            f"{len(trees_in)} dyn_trees_batch calls in FULL_WINDOW's encode")

    tokenize_args = (rows, ends, tok_cap, pwin)
    dyn_args = (drows, dends, prep["tab"], starts, status,
                torch.zeros_like(starts), tok_cap, pwin)
    cases = [
        ("match_bitplane_batch", "match2.cu", "tpu_deflate/kernels/match2.py:201",
         match_bitplane_batch, match_bitplane_plain,
         (chunks, lens, cfg.window, cfg.max_match), work_match, None),
        ("mono_scatter_add", "monotone.cu", "tpu_deflate/kernels/monotone.py:110",
         mono_scatter_add, mono_scatter_add_plain, (idx, ch, M + 8),
         work_scatter, scatter_library(idx, ch, M + 8)),
        ("far_match_batch", "farmatch.cu",
         "none (tpu_deflate/ops/encode.py:162 _match_candidates_multi, jnp glue)",
         far_match_batch, E._far_match_plain,
         (chunks, lens, FULL_WINDOW.window, FULL_WINDOW.max_match), work_far, None),
        ("dyn_trees_batch", "dyntrees.cu",
         "none (tpu_deflate/ops/encode.py:515 _assign_code_lengths_jax, :589, :683 "
         "and the choice in _encode_emissions, jnp glue)",
         dyn_trees_batch, trees_plain, trees_in[0], work_trees, None),
        ("tokenize_static_batch", "tokenize.cu",
         "tpu_deflate/kernels/tokenize.py:469",
         tokenize_static_batch, tokenize_static_plain, tokenize_args,
         work_tokenize, None),
        ("expand_fused3", "expand3.cu", "tpu_deflate/kernels/expand3.py:389",
         expand_fused3, expand_fused3_plain,
         (rows, off, c1, tb, tp, total, chunk),
         lambda a, o: work_expand(a[4], a[5], o[0]), None),
        ("tokenize_dyn_batch", "tokenize_dyn.cu",
         "tpu_deflate/kernels/tokenize_dyn.py:465",
         tokenize_dyn_batch, tokenize_dyn_plain, dyn_args, work_tokenize_dyn,
         None),
        ("mono_compact", "monotone.cu", "tpu_deflate/kernels/monotone.py:243",
         mono_compact, mono_compact_plain, paints[0], work_scatter,
         scatter_library(*paints[0])),
        ("resolve_roots", "resolve.cu", "tpu_deflate/kernels/resolve.py:156",
         resolve_roots, lambda p, v: resolve_roots_plain(p.long(), v.long()),
         chain, work_resolve, None),
        ("expand_fused2", "expand2.cu", "tpu_deflate/kernels/expand2.py:337",
         expand_fused2, expand_fused2_plain, seg,
         lambda a, o: work_expand(a[3], a[4], o[0]), None),
        ("ent_from_phi", "chase1.cu", "tpu_deflate/kernels/chase1.py:91",
         ent_from_phi, ent_from_phi_plain, maps[mid], work_ent, None),
        ("visited_from_adv", "chase1.cu", "tpu_deflate/kernels/chase1.py:140",
         visited_from_adv, visited_from_adv_plain, visits[mid % v6],
         work_visit, None),
        ("tokenize_dyn_hier", "tokenize_hier.cu",
         "tpu_deflate/kernels/tokenize_dyn.py:465", tokenize_dyn_hier,
         tokenize_dyn_hier_plain, blocks_in[mid], work_hier, None),
    ]
    # each kernel's chain of dependent steps and the cycles of a step:
    # log2 of a chase's tiles or positions; for the tile-parallel tokenizer
    # the doubling of a tile's maps (5 rounds), the composition over the
    # tiles and a tile's walk (33); for expand_fused2 and resolve_roots the
    # longest chase across tiles their data needs (for resolve_roots, whose
    # chases jump pointers, its depth by doubling)
    serial_steps = {
        "ent_from_phi": (lambda a, o: a[0].shape[2].bit_length() - 1, STEP_CYCLES),
        "visited_from_adv": (lambda a, o: (a[0].numel() + 1).bit_length(),
                             STEP_CYCLES),
        "tokenize_dyn_hier": (lambda a, o: 5 + (a[4] // 64).bit_length() - 1 + 33,
                              STEP_CYCLES),
        "expand_fused2": (lambda a, o: expand2_chain(a, E2_TILE), L2_CYCLES),
        "resolve_roots": (lambda a, o: jump_depth(resolve_chase(a, RES_TILE)),
                          L2_CYCLES),
    }
    results = []
    for kname, src, replaces, kern, plain, args, work, library in cases:
        got, want = kern(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"{kname} differs from its plain version by {err}")
        ms = cuda_ms(lambda: kern(*args), reps=10)
        dev_ms = device_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps=2)
        library_ms = library_dev_ms = None
        if library is not None:
            require(max_abs_err((library(),), got) == 0,
                    f"{kname}: the library call differs from the kernel")
            library_ms = cuda_ms(library, reps=10)
            library_dev_ms = device_ms(library)
        bound_ms, bound_by = bound(*work(args, got))
        serial_ms = None
        if kname in serial_steps:
            steps_of, cycles = serial_steps[kname]
            steps = steps_of(args, got)
            serial_ms = steps * cycles / SM_HZ * 1e3
            log(f"kernel {kname}: {steps} dependent steps, "
                f"{ms / max(steps, 1) * 1e6:.1f} ns a step; serial bound "
                f"{serial_ms:.5f} ms at {cycles} cycles a step")
        if kname == "tokenize_dyn_hier":
            split = device_split(lambda: kern(*args), 10)
            ent_part = sum(v for k, v in split.items() if "ent_kernel" in k)
            log(f"kernel tokenize_dyn_hier: device {sum(split.values()):.4f} ms, "
                f"without ent_kernel {sum(split.values()) - ent_part:.4f} ms; "
                "by launch: " + ", ".join(f"{k[:48]} {v:.4f}"
                                          for k, v in sorted(split.items())))
            # K1d's floor: the window read once, its plane and maps
            # written once
            k1d_ms = sum(v for k, v in split.items() if "k1d_kernel" in k)
            k1d_floor = bound(args[4] // 8 + 5 * args[4] + nbytes(args[2]), 0)[0]
            log(f"kernel tokenize_dyn_hier, K1d: device {k1d_ms:.4f} ms, floor "
                f"{k1d_floor:.5f} ms by bytes; serial 5 doubling rounds "
                f"{5 * STEP_CYCLES / SM_HZ * 1e3:.5f} ms on {name}, {smi}")
        if kname == "resolve_roots":
            per_call = device_launches(lambda: kern(*args), 5)
            require(sum(per_call.values()) <= 2 and all(
                "resolve" in k for k in per_call), f"resolve_roots launches {per_call}")
            torch.cuda.set_sync_debug_mode("error")  # a host read raises
            try:
                kern(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            log(f"kernel resolve_roots: launches a call {per_call}, no memset "
                "and no host read")
        lanes = got[0].shape[0]
        log(f"kernel {kname}: equal to plain on {lanes} lanes; device "
            f"{fmt_ms(dev_ms)}, host-paced {ms:.4f} ms (plain {plain_ms:.3f} "
            f"ms, library call "
            f"{'none' if library_ms is None else f'device {fmt_ms(library_dev_ms)}, host-paced {library_ms:.4f} ms'}"
            f", bound {bound_ms:.5f} ms by {bound_by}) on {name}, {smi}")
        results.append(dict(
            name=kname, route="cuda", source=f"tpu_deflate_torch/csrc/{src}",
            replaces=replaces, fn=kern, max_abs_err=err, ms=ms,
            device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms,
            library_device_ms=library_dev_ms, serial_bound_ms=serial_ms,
            launches_by_path={},
        ))

    # the matcher where its time and its edges lie: 8 MiB of seeded random
    # bytes (nothing matches: every chain walk runs out of the window) and
    # of zeros (every position matches at distance 1), timed beside the corpus;
    # then lanes cut short (bytes past n are 7) at the (window, max_match)
    # corners, corpus, zeros and random lanes among them
    mgen = torch.Generator().manual_seed(SEED + 1)
    rnd = torch.randint(0, 256, (B, chunk), generator=mgen, dtype=torch.uint8).to(dev)
    for what, mrows in (("random bytes", rnd), ("zeros", torch.zeros_like(chunks))):
        margs = (mrows, lens, cfg.window, cfg.max_match)
        err = max_abs_err(match_bitplane_batch(*margs), match_bitplane_plain(*margs))
        require(err == 0, f"match_bitplane_batch differs from plain on {what} by {err}")
        dev_ms = device_ms(lambda: match_bitplane_batch(*margs))
        host_ms = cuda_ms(lambda: match_bitplane_batch(*margs), reps=10)
        log(f"kernel match_bitplane_batch on {SIZE} B of {what}: equal to "
            f"plain; device {fmt_ms(dev_ms)}, host-paced {host_ms:.4f} ms (the "
            f"corpus: device {fmt_ms(results[0]['device_ms'])}) on {name}, {smi}")
    short = chunks[:16].clone()
    short[8:12] = 0
    short[12:] = rnd[:4]
    slens = torch.tensor([chunk - 977 * r - r % 3 for r in range(16)],
                         dtype=torch.int32, device=dev)
    short = torch.where(torch.arange(chunk, device=dev) >= slens[:, None], 7, short)
    short = short.to(torch.uint8)
    for mwin, mmax in ((1, 3), (100, 10), (256, 258)):
        margs = (short, slens, mwin, mmax)
        got = match_bitplane_batch(*margs)
        err = max_abs_err(got, match_bitplane_plain(*margs))
        require(err == 0, f"match_bitplane_batch differs from plain at window "
                f"{mwin}, max_match {mmax} by {err}")
        require(int(got[1].max()) == mmax, f"longest match {int(got[1].max())}")
    log(f"kernel match_bitplane_batch: equal to plain on 16 lanes cut short "
        f"(corpus, zeros, random) at (window, max_match) (1, 3), (100, 10), "
        f"(256, 258)")

    # the exact far matcher: the corpus at window 1024, 8 MiB of random
    # bytes and of zeros and one row of 1 MiB (B = 1, as a shard encodes
    # it) at the full window, each timed beside its plain version; the
    # short lanes at (window, max_match) (300, 12), (1024, 258), (32768,
    # 258); the launches of a call and of the whole match stage
    fw_win, fw_max = FULL_WINDOW.window, FULL_WINDOW.max_match
    far_cases = (("the corpus at window 1024", (chunks, lens, 1024, fw_max)),
                 ("random bytes", (rnd, lens, fw_win, fw_max)),
                 ("zeros", (torch.zeros_like(chunks), lens, fw_win, fw_max)),
                 ("one row of 1 MiB", (chunks.reshape(-1, 1 << 20)[:1], lens[:1] * 16,
                                       fw_win, fw_max)))
    for what, fargs in far_cases:
        got = far_match_batch(*fargs)
        err = max_abs_err(got, E._far_match_plain(*fargs))
        require(err == 0, f"far_match_batch differs from plain on {what} by {err}")
        fdev = device_ms(lambda: far_match_batch(*fargs))
        fplain = cuda_ms(lambda: E._far_match_plain(*fargs), reps=2)
        fbound = bound(*work_far(fargs, got))[0]
        log(f"kernel far_match_batch on {what} ({tuple(fargs[0].shape)}, window "
            f"{fargs[2]}): equal to plain; device {fmt_ms(fdev)}, bound {fbound:.5f} "
            f"ms, plain {fplain:.3f} ms on {name}, {smi}")
    for mwin, mmax in ((300, 12), (1024, 258), (32768, 258)):
        got = far_match_batch(short, slens, mwin, mmax)
        err = max_abs_err(got, E._far_match_plain(short, slens, mwin, mmax))
        require(err == 0, f"far_match_batch differs from plain at window {mwin}, "
                f"max_match {mmax} by {err}")
        require(int(got[1].max()) == mmax, f"longest match {int(got[1].max())}")
    per_call = device_launches(lambda: far_match_batch(chunks, lens, fw_win, fw_max), 5)
    stage = device_launches(lambda: E._match(chunks, lens, FULL_WINDOW), 5)
    stage_ms = device_ms(lambda: E._match(chunks, lens, FULL_WINDOW))
    require(sum(stage.values()) <= 40, f"the match stage launches {stage}")
    log(f"kernel far_match_batch: equal to plain on 16 lanes cut short (corpus, "
        f"zeros, random) at (window, max_match) (300, 12), (1024, 258), (32768, "
        f"258); a call launches {sum(per_call.values()):.0f} ops ("
        + ", ".join(f"{k[:60]} {v:.0f}" for k, v in sorted(per_call.items()))
        + f"); FULL_WINDOW's match stage with the lazy step {sum(stage.values()):.0f} "
        f"ops, device {fmt_ms(stage_ms)} on {name}, {smi}")

    # the dynamic trees on the hand-built lanes, one by one and as one batch
    # (each lane's positions padded with no start); the plain version's
    # device time on FULL_WINDOW's 128 corpus lanes; the launches of
    # FULL_WINDOW's emit stage
    from tpu_deflate_torch import lanes as L

    edge = [L.tree_edge_lane(t) for t in L.TREE_EDGE_LANES]
    uses = []
    for tname, (st, ls, ds) in zip(L.TREE_EDGE_LANES, edge):
        targs = tuple(torch.from_numpy(x)[None].to(dev) for x in (st, ls, ds))
        got = dyn_trees_batch(*targs)
        err = max_abs_err(got, trees_plain(*targs))
        require(err == 0, f"dyn_trees_batch differs from plain on the lane {tname} "
                f"by {err}")
        uses.append(bool(got[0][0]))
    require(uses == [False, False, True, False, True, False],
            f"dynamic trees chosen on the hand-built lanes: {uses}")
    width = max(len(x[0]) for x in edge) + 3
    targs = [torch.zeros(len(edge), width, dtype=dt) for dt in (torch.bool, torch.int64,
                                                                 torch.int64)]
    for r, lane in enumerate(edge):
        for t, x in zip(targs, lane):
            t[r, : len(x)] = torch.from_numpy(x)
    targs = tuple(t.to(dev) for t in targs)
    err = max_abs_err(dyn_trees_batch(*targs), trees_plain(*targs))
    require(err == 0, f"dyn_trees_batch differs from plain on the hand-built lanes "
            f"as one batch by {err}")
    tplain = device_ms(lambda: trees_plain(*trees_in[0]))
    emit_args = (chunks, lens, finals, *E._match(chunks, lens, FULL_WINDOW), True)
    emit = device_launches(lambda: E._encode_emissions(*emit_args), 3)
    emit_ms = device_ms(lambda: E._encode_emissions(*emit_args))
    log(f"kernel dyn_trees_batch: equal to plain on the hand-built lanes "
        f"{list(L.TREE_EDGE_LANES)}, one by one (dynamic trees on {uses}) and as "
        f"one batch of {tuple(targs[0].shape)}; the plain version's device time on "
        f"FULL_WINDOW's 128 corpus lanes {fmt_ms(tplain)}; FULL_WINDOW's emit stage launches "
        f"{sum(emit.values()):.0f} device ops, device {fmt_ms(emit_ms)}, on {name}, "
        f"{smi}")

    # the bit-pack on the dynamic path's entries (C = 3), on the encoder's
    # entries over zeros at max_match 258 (runs of one index of at least
    # 257 entries, 515 with dynamic trees, whose codes are shorter), and on
    # seeded entries: a dead head of two values, a dead tail, a lane with no
    # live entry (all before, all after), runs over one and over two slabs
    # of 2048, gaps of 40
    dist_d, length_d = match_bitplane_batch(chunks, lens, dcfg.window, dcfg.max_match)
    dvals, dnbs, doffs, _, _ = E._encode_emissions(chunks, lens, finals, dist_d,
                                                   length_d, True)
    didx, dch = E._bitpack_entries(dvals, dnbs, doffs, E._emission_bits(dcfg))
    pack_cases = [("the dynamic path's entries", didx, dch, M + 8)]
    zrows = torch.zeros(4, chunk, dtype=torch.uint8, device=dev)
    zlens = torch.full((4,), chunk, dtype=torch.int32, device=dev)
    zdist, zlen = match_bitplane_batch(zrows, zlens, 256, 258)
    for zdyn in (False, True):
        zcfg = DeflateConfig(window=256, max_match=258, dynamic_encode=zdyn)
        zv, znb, zoff, _, _ = E._encode_emissions(zrows, zlens, finals[-4:], zdist,
                                                  zlen, zdyn)
        zidx, zch = E._bitpack_entries(zv, znb, zoff, E._emission_bits(zcfg))
        run = int(torch.unique_consecutive(zidx[0], return_counts=True)[1].max())
        require(run >= (515 if zdyn else 257), f"longest run {run}")
        pack_cases.append((f"zeros at max_match 258, runs of {run}", zidx, zch, M + 8))
    K = 3 * 2048 + 5
    step = torch.randint(0, 5, (8, K), generator=mgen)
    step[:, ::97] = 40
    sidx = torch.cumsum(step, 1)
    ssize = int(sidx[:, -1].max()) + 40
    sidx[0, :50], sidx[0, 50:60] = -1, -7
    sidx[1, -300:] = ssize + 5
    sidx[2], sidx[3] = -1, ssize + 1
    sidx[4, 100:5100] = sidx[4, 100].clone()
    sidx[5, 2040 : 2 * 2048 + 10] = sidx[5, 2040].clone()
    svals = torch.randint(0, 1 << 16, (8, 3, K), generator=mgen, dtype=torch.int32)
    pack_cases.append(("seeded edge lanes", sidx.to(torch.int32).to(dev),
                       svals.to(dev), ssize))
    # runs of one index over most of a lane: every entry past n takes the
    # offset of the end-of-block code.  The main path's batch with its last
    # lane cut to N / 8 (a compress whose last chunk is partial) and with
    # every lane cut so, static (C = 2) and dynamic (C = 3); then the one
    # call of a one_block compress of 1.125 MiB, one lane of 2 MiB, static
    # and dynamic.  Each is timed.
    timed = []
    for cut in ("last lane", "every lane"):
        clens = lens.clone()
        if cut == "last lane":
            clens[-1] = chunk // 8
        else:
            clens[:] = chunk // 8
        for ccfg in (cfg, dcfg):
            cd, cl = match_bitplane_batch(chunks, clens, ccfg.window, ccfg.max_match)
            cv, cnb, coff, _, _ = E._encode_emissions(chunks, clens, finals, cd, cl,
                                                      ccfg.dynamic_encode)
            cidx, cch = E._bitpack_entries(cv, cnb, coff, E._emission_bits(ccfg))
            run = int(torch.unique_consecutive(cidx[-1], return_counts=True)[1].max())
            timed.append((f"{cut} cut to N / 8, C = {cch.shape[1]}, a run of {run}",
                          cidx, cch, M + 8))
    ob_data = data[: 9 << 17]
    for ob_dyn in (False, True):
        ob_cfg = DeflateConfig(one_block=True, dynamic_encode=ob_dyn)
        ob_calls = []
        orig = capture(E, "mono_scatter_add", ob_calls)
        ob_stream = compress(ob_data, ob_cfg, device=dev)
        E.mono_scatter_add = orig
        require(zlib.decompress(ob_stream) == ob_data, "zlib rejects a one_block stream")
        require(len(ob_calls) == 1, f"{len(ob_calls)} bit-packs in a one_block compress")
        oidx, och, osize = ob_calls[0]
        run = int(torch.unique_consecutive(oidx[0], return_counts=True)[1].max())
        timed.append((f"a one_block compress of {len(ob_data)} B, C = "
                      f"{och.shape[1]}, K = {oidx.shape[1]}, a run of {run}",
                      oidx, och, osize))
    for what, pidx, pvals, psize in pack_cases + timed:
        err = max_abs_err((mono_scatter_add(pidx, pvals, psize),),
                          (mono_scatter_add_plain(pidx, pvals, psize),))
        require(err == 0, f"mono_scatter_add differs from plain on {what} by {err}")
        log(f"kernel mono_scatter_add: equal to plain on {what} "
            f"({tuple(pvals.shape)} -> size {psize})")
    for what, pidx, pvals, psize in timed:
        pargs = (pidx, pvals, psize)
        pms = device_ms(lambda: mono_scatter_add(*pargs))
        pbound = bound(*work_scatter(pargs, (mono_scatter_add(*pargs),)))[0]
        log(f"kernel mono_scatter_add on {what}: device {fmt_ms(pms)}, bound "
            f"{pbound:.5f} ms on {name}, {smi}")
    pack_dyn_ms = device_ms(lambda: mono_scatter_add(didx, dch, M + 8))
    pack_split = device_split(lambda: mono_scatter_add(idx, ch, M + 8), 5)
    require(all("mono_scatter_add" in k for k in pack_split),
            f"the bit-pack launches more than its kernels: {sorted(pack_split)}")
    memset_ms = device_ms(lambda: torch.zeros(B, ch.shape[1], M + 8,
                                              dtype=torch.int32, device=dev))
    log(f"kernel mono_scatter_add: device {fmt_ms(results[1]['device_ms'])} "
        f"static (C = {ch.shape[1]}), {fmt_ms(pack_dyn_ms)} dynamic (C = "
        f"{dch.shape[1]}, {dch.shape[2]} entries a lane); it launches its "
        f"two kernels {sorted(pack_split)} and no memset (the memset of its "
        f"output by torch.zeros, gone: "
        f"{fmt_ms(memset_ms)}) on {name}, {smi}")

    # the static tokenizer on lanes that end in each of its errors, at the
    # decode path's pass and at passes of 1088 bits, over a token capacity
    # that some lanes overflow, and as whole streams: every output equal,
    # the token slots past each lane's count too
    from tpu_deflate_torch.kernels import tokenize as KT

    expect = {"static": KT.ERR_OK, "stored": KT.ERR_OK,  # where tokens fit
              "stored_then_static": KT.ERR_OK, "empty": KT.ERR_OK,
              "eob_only": KT.ERR_OK, "dynamic": KT.ERR_DYNAMIC,
              "too_far": KT.ERR_DIST, "method3": KT.ERR_METHOD,
              "bad_stored": KT.ERR_STORED}
    elanes, erows, eends = error_lanes(data, torch)
    erows, eends = erows.to(dev), eends.to(dev)
    ew = erows.shape[1]
    for cap, epwin, whole in ((ew + 16, D.chunk_pwin(ew), False),
                              (ew + 16, 17 << 6, False),
                              (300, D.chunk_pwin(ew), False),
                              (ew + 16, D.chunk_pwin(ew), True)):
        eargs = (erows, eends, cap, epwin, not whole)
        got = tokenize_static_batch(*eargs)
        want = tokenize_static_plain(*eargs)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        codes = dict(zip(elanes, got[6].tolist()))
        require(err == 0, f"tokenize_static_batch differs from plain on the "
                f"error lanes (tok_cap {cap}, pwin {epwin}) by {err}; {codes}")
        if cap < ew:
            require(codes["static_text"] == KT.ERR_OVERFLOW,
                    f"no overflow at tok_cap {cap}: {codes}")
        else:
            for lname, code in expect.items():
                require(codes[lname] == code,
                        f"lane {lname}: error {codes[lname]}, expected {code}")
        log(f"kernel tokenize_static_batch: equal to plain on {len(elanes)} "
            f"error lanes at tok_cap {cap}, pwin {epwin}"
            f"{', whole streams' if whole else ''}; errors {codes}")

    # the dynamic tokenizer on lanes that end in each of its outcomes, each
    # also resumed after earlier tokens and output (tok0, TAB_OUTBASE), at
    # the decode path's pass and at passes of 1088 bits, over a token
    # capacity that some lanes overflow, and into the caller's buffers:
    # every output equal, the token slots outside the block's tokens too
    from tpu_deflate_torch import lanes as L

    dlanes = dyn_error_lanes(data, L)
    dnames = [n for n, _, _ in dlanes]
    drows_e = torch.zeros(len(dlanes), ew, dtype=torch.uint8)
    for i, (lname, lane, _) in enumerate(dlanes):
        require(len(lane) <= ew, f"dynamic error lane {lname} too long")
        drows_e[i, : len(lane)] = torch.frombuffer(bytearray(lane), dtype=torch.uint8)
    dends_e = torch.tensor([e for _, _, e in dlanes], dtype=torch.int32)
    dprep = D.dyn_header_params_batch(drows_e.to(dev), dends_e.to(dev))
    dcoded, dstarts, dstatus = D.dyn_lanes(dprep)
    require(bool(dcoded.all()), "a dynamic error lane is not coded")
    require(int(dprep["min_len"][dnames.index("huffman_only")]) == 1,
            "the Z_HUFFMAN_ONLY lane has no 1-bit code")
    resumed = {"zlib9": (5, 40), "far": (7, 300), "wide": (3, 9),
               "huffman_only": (1, 1), "cl_oversub": (4, 4)}
    src = torch.tensor(list(range(len(dnames))) + [dnames.index(k) for k in resumed],
                       device=dev)
    etab = dprep["tab"][src].clone()
    etab[len(dnames):, KD.TAB_OUTBASE] = torch.tensor(
        [ob for _, ob in resumed.values()], dtype=torch.int32, device=dev)
    etok0 = torch.tensor([0] * len(dnames) + [t0 for t0, _ in resumed.values()],
                         dtype=torch.int32, device=dev)
    dargs = (drows_e.to(dev)[src], dends_e.to(dev)[src], etab, dstarts[src],
             dstatus[src], etok0)
    anames = dnames + [f"{k}_resumed" for k in resumed]
    for cap, epwin, into in ((ew + 16, D.chunk_pwin(ew), False),
                             (ew + 16, 17 << 6, False),
                             (300, D.chunk_pwin(ew), False),
                             (ew + 16, D.chunk_pwin(ew), True)):
        bufs = (torch.randint(1, 99, (3, len(anames), cap), dtype=torch.int32,
                              generator=rng).to(dev) if into else None)
        got = tokenize_dyn_batch(*dargs, cap, epwin,
                                 into=tuple(bufs.clone()) if into else None)
        want = tokenize_dyn_plain(*dargs, cap, epwin,
                                  into=tuple(bufs.clone()) if into else None)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        codes = dict(zip(anames, got[6].tolist()))
        require(err == 0, f"tokenize_dyn_batch differs from plain on the error "
                f"lanes (tok_cap {cap}, pwin {epwin}) by {err}; {codes}")
        if cap < ew:
            require(codes["zlib9"] == codes["huffman_only"] == KT.ERR_OVERFLOW,
                    f"no overflow at tok_cap {cap}: {codes}")
        else:
            require(all(codes[k] == KT.ERR_OK for k in (
                "zlib1", "zlib6", "zlib9", "huffman_only", "wide", "far_resumed")),
                f"dynamic lanes: {codes}")
            require(codes["far"] == KT.ERR_DIST and codes["bad_code"] == KT.ERR_BAD_CODE
                    and codes["truncated"] in (KT.ERR_BAD_CODE, KT.ERR_INPUT)
                    and codes["cl_oversub"] == int(dstatus[dnames.index("cl_oversub")]) >= 0,
                    f"dynamic error lanes: {codes}")
        log(f"kernel tokenize_dyn_batch: equal to plain on {len(anames)} error "
            f"lanes at tok_cap {cap}, pwin {epwin}"
            f"{', into the caller buffers' if into else ''}; errors {codes}")

    # the same kernel through the general pipeline, one lane a launch: a
    # Z_HUFFMAN_ONLY stream with a 1-bit code and zlib -6 of 1 MiB, each
    # call's arguments kept (the token buffers before the call) and run
    # again against the plain version
    general_calls = []
    dyn_kernel = D.tokenize_dyn_batch

    def keep_call(*a, into=None):
        general_calls.append((a, tuple(x.clone() for x in into)))
        return dyn_kernel(*a, into=into)

    D.tokenize_dyn_batch = keep_call
    skew = bytes(3 << 16) + data[: 1 << 16]
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 8, zlib.Z_HUFFMAN_ONLY)
    for zs, want_bytes in ((co.compress(skew) + co.flush(), skew),
                           (zlib.compress(data[: 1 << 20], 6)[2:], data[: 1 << 20])):
        first = len(general_calls)
        gout, gtotal, _ = D._inflate_general(zs, device=dev)
        require(gout[:gtotal].tobytes() == want_bytes, "the general pipeline "
                "did not return the input")
        require(len(general_calls) > first, "no dynamic block")
        general_calls[first + 2 :] = []
    D.tokenize_dyn_batch = dyn_kernel
    for a, bufs in general_calls:
        got = tokenize_dyn_batch(*a, into=tuple(x.clone() for x in bufs))
        want = tokenize_dyn_plain(*a, into=tuple(x.clone() for x in bufs))
        err = max_abs_err(got, want)
        require(err == 0, f"tokenize_dyn_batch differs from plain on the general "
                f"pipeline's lane by {err}")
    log(f"kernel tokenize_dyn_batch: equal to plain on {len(general_calls)} "
        f"calls of the general pipeline (B = 1, a 1-bit code and zlib -6)")

    # both expanders where a match reaches before the row: the lane of
    # bytes 65 66 65 65 65 65 67, seeded lanes, the too_far error lane's
    # tokens; then expand_fused3 on a distance-1 run of 64 KiB, a stored
    # token as wide as the row, and rows of 4096 bytes
    ftk, fta, ftb, ftp = (torch.from_numpy(x) for x in L.far_token_lanes(SEED))
    etk, eta, etb, etp, *_ = tokenize_static_batch(erows, eends, ew + 16,
                                                   D.chunk_pwin(ew))
    tf = elanes.index("too_far")  # a lane more: that lane's tokens
    n_tf = int(etp[tf])
    ftk, fta, ftb = (torch.cat([x, torch.nn.functional.pad(
        y[tf : tf + 1, :n_tf].cpu(), (0, x.shape[1] - n_tf))])
        for x, y in ((ftk, etk), (fta, eta), (ftb, etb)))
    ftp = torch.cat([ftp, torch.tensor([n_tf], dtype=torch.int32)])
    ftk, fta, ftb, ftp = (x.to(dev) for x in (ftk, fta, ftb, ftp))
    foff, fc1, ftotal = X._expand_inputs(ftk, fta, ftp)
    fcap = 2048 * -(-int(ftotal.max()) // 2048)
    frows = torch.zeros(ftk.shape[0], 1, dtype=torch.uint8, device=dev)
    for kname, kern, plain, args in (
        ("expand_fused3", expand_fused3, expand_fused3_plain,
         (frows, foff, fc1, ftb, ftp, ftotal, fcap)),
        ("expand_fused2", expand_fused2, expand_fused2_plain,
         (foff, fc1, ftb, ftp, ftotal, fcap)),
    ):
        got = kern(*args)
        require(torch.equal(got, plain(*args)), f"{kname} differs from plain "
                "where matches reach before the row")
        require(got[0, :7].tolist() == L.FAR_BYTES
                and got[-1, : int(ftotal[-1])].eq(65).all(),
                f"{kname}: {got[0, :7].tolist()}, too_far lane "
                f"{got[-1, : int(ftotal[-1])].tolist()}")
    log(f"expanders: expand_fused3 and expand_fused2 equal to plain on "
        f"{ftk.shape[0]} lanes with matches before the row (the too_far lane "
        f"of {n_tf} tokens among them)")
    wide = 1 << 16
    n_run = wide // 258
    tk3, ta3, tb3 = (torch.zeros(2, wide + 16, dtype=torch.int32) for _ in range(3))
    tk3[0, 1 : n_run + 2], ta3[0, 1 : n_run + 2], tb3[0, 1 : n_run + 2] = 1, 258, 1
    ta3[0, 0], ta3[0, n_run + 1] = 65, wide - 1 - 258 * n_run
    tk3[1, 0], ta3[1, 0], tb3[1, 0] = 2, wide, 40  # stored, the whole row
    tp3 = torch.tensor([n_run + 2, 1], dtype=torch.int32)
    rows3 = torch.randint(0, 256, (2, wide + 40), generator=rng, dtype=torch.uint8)
    tk3, ta3, tb3, tp3, rows3 = (x.to(dev) for x in (tk3, ta3, tb3, tp3, rows3))
    off3, c13, total3 = X._expand_inputs(tk3, ta3, tp3)
    args3 = (rows3, off3, c13, tb3, tp3, total3, wide)
    got = expand_fused3(*args3)
    require(torch.equal(got, expand_fused3_plain(*args3)),
            "expand_fused3 differs from plain on a distance-1 run or a stored row")
    require(bool(got[0].eq(65).all()) and torch.equal(got[1], rows3[1, 40:]),
            "expand_fused3: the run or the stored row is wrong")
    run3_ms = cuda_ms(lambda: expand_fused3(*args3), reps=10)
    eoff, ec1, etotal = X._expand_inputs(etk, eta, etp)
    args4 = (erows, eoff, ec1, etb, etp, etotal, ew)
    require(torch.equal(expand_fused3(*args4), expand_fused3_plain(*args4)),
            "expand_fused3 differs from plain on rows of 4096 bytes")
    log(f"kernel expand_fused3: equal to plain on a distance-1 run of {wide} "
        f"bytes and a stored token of the whole row ({run3_ms:.4f} ms "
        f"host-paced), and on {len(elanes)} rows of {ew} bytes on {name}, {smi}")

    # the two new kernels again where trouble is likely: a chain as deep as
    # the row (a distance-1 run over a whole segment, over a whole 1 MiB
    # row) and distances up to 32768, on synthetic lanes
    N = F.SEG_CAP
    at = torch.arange(N, device=dev)
    back = torch.randint(1, 32769, (N,), generator=rng).to(dev)
    forest = torch.where(torch.rand(N, generator=rng).to(dev) < 0.8,
                         (at - back).clamp_min(0), at)
    parent = torch.stack([(at - 1).clamp_min(0), forest]).to(torch.int32)
    val = torch.randint(0, 256, (2, N), generator=rng, dtype=torch.int32).to(dev)
    got = resolve_roots(parent, val)
    require(torch.equal(got.long(), resolve_roots_plain(parent.long(), val.long())),
            "resolve_roots differs from plain on a distance-1 run of a segment")
    deep_ms = cuda_ms(lambda: resolve_roots(parent, val), reps=5)

    row_cap = 1 << 20
    run = 1 + 258 * ((row_cap - 1) // 258)
    n_lit, n_far = 32768, 3000
    far_len = torch.randint(3, 259, (n_far,), generator=rng)
    K = max((run - 1) // 258 + 1, n_lit + n_far)
    tk2, ta2, tb2 = (torch.zeros(2, K, dtype=torch.int32) for _ in range(3))
    tk2[0, 1 : 1 + run // 258] = 1  # lane 0: a byte, then its run to 1 MiB
    ta2[0, 0], ta2[0, 1 : 1 + run // 258], tb2[0, 1 : 1 + run // 258] = 65, 258, 1
    ta2[1, :n_lit] = torch.randint(0, 256, (n_lit,), generator=rng)
    tk2[1, n_lit : n_lit + n_far] = 1  # lane 1: matches at any distance
    ta2[1, n_lit : n_lit + n_far] = far_len
    tb2[1, n_lit : n_lit + n_far] = torch.randint(1, 32769, (n_far,), generator=rng)
    tp2 = torch.tensor([1 + run // 258, n_lit + n_far], dtype=torch.int32)
    off2, c12, total2 = X._expand_inputs(tk2.to(dev), ta2.to(dev), tp2.to(dev))
    args2 = (off2, c12, tb2.to(dev), tp2.to(dev), total2, row_cap)
    require(int(total2[0]) == run and int(total2[1]) <= row_cap, "synthetic lanes")
    require(torch.equal(expand_fused2(*args2), expand_fused2_plain(*args2)),
            "expand_fused2 differs from plain on a distance-1 run of 1 MiB")
    run_ms = cuda_ms(lambda: expand_fused2(*args2), reps=5)
    log(f"deep chains: resolve_roots on a distance-1 run of {N} and a forest "
        f"with distances to 32768 equal to plain, {deep_ms:.3f} ms; "
        f"expand_fused2 on a distance-1 run of {run} bytes and {n_far} "
        f"matches at distances to 32768 equal to plain, {run_ms:.3f} ms "
        f"on {name}, {smi}")
    # the distance-1 run of 1 MiB alone: every tile copies from the one
    # before it, the longest chase a row can have
    args1 = tuple(x[:1] for x in args2[:5]) + (row_cap,)
    chase1 = expand2_chain(args1, E2_TILE)
    run1_dev = device_ms(lambda: expand_fused2(*args1))
    run1_ms = cuda_ms(lambda: expand_fused2(*args1), reps=10)
    run1_bound = bound(*work_expand(args1[3], args1[4], expand_fused2(*args1)))[0]
    log(f"kernel expand_fused2 on the distance-1 run of {run} bytes (B = 1): "
        f"device {fmt_ms(run1_dev)}, host-paced {run1_ms:.4f} ms; a chase of "
        f"{chase1} steps; bound {run1_bound:.5f} ms by bytes, serial "
        f"{chase1 * L2_CYCLES / SM_HZ * 1e3:.5f} ms on {name}, {smi}")

    # resolve_roots on every segment that the stored-mix decode above
    # handed it, on the distance-1 run of a segment alone (its chase
    # crosses every tile), timed, and on edge forests
    # (tpu_deflate_torch.lanes): parents after their positions, a chain
    # that zigzags across 16 tiles, three rows of no tile multiple, rows of
    # one position
    for a in chains:
        require(torch.equal(resolve_roots(*a).long(),
                            resolve_roots_plain(a[0].long(), a[1].long())),
                "resolve_roots differs from plain on a stored-mix segment")
    d1 = (parent[:1].contiguous(), val[:1].contiguous())
    d1_chase = resolve_chase(d1, RES_TILE)
    d1_dev = device_ms(lambda: resolve_roots(*d1))
    d1_ms = cuda_ms(lambda: resolve_roots(*d1), reps=10)
    d1_bound = bound(*work_resolve(d1, (resolve_roots(*d1),)))[0]
    log(f"kernel resolve_roots on the distance-1 run of a segment ({N} "
        f"positions, B = 1): device {fmt_ms(d1_dev)}, host-paced "
        f"{d1_ms:.4f} ms; a chase of {d1_chase} steps, {jump_depth(d1_chase)} "
        f"by doubling; bound {d1_bound:.5f} ms by bytes, serial "
        f"{jump_depth(d1_chase) * L2_CYCLES / SM_HZ * 1e3:.5f} ms on {name}, {smi}")
    forests = L.resolve_edge_forests(RES_TILE, SEED)
    for fname, (fp, fv) in forests.items():
        fa = (torch.from_numpy(fp).to(dev), torch.from_numpy(fv).to(dev))
        require(torch.equal(resolve_roots(*fa).long(),
                            resolve_roots_plain(fa[0].long(), fa[1].long())),
                f"resolve_roots differs from plain on the edge forest {fname}")
    log(f"kernel resolve_roots: equal to plain on all {len(chains)} stored-mix "
        f"segments and on edge forests {sorted(forests)} (tiles of {RES_TILE})")

    # expand_fused2 on every segment and ent_from_phi on every block's maps
    # that the -6 and stored-mix decodes above handed them, then on edge
    # lanes and maps built here
    for a in segs:
        require(torch.equal(expand_fused2(*a), expand_fused2_plain(*a)),
                f"expand_fused2 differs from plain on a segment of {a[5]} bytes")
    for a in maps:
        require(torch.equal(ent_from_phi(*a), ent_from_phi_plain(*a)),
                "ent_from_phi differs from plain on a block's maps")
    log(f"kernels expand_fused2 and ent_from_phi: equal to plain on all "
        f"{len(segs)} segments and all {len(maps)} blocks' maps of the -6 and "
        f"stored-mix -6 decodes")
    enames, etk5, eta5, etb5, etp5, ecut, ecap = L.expand2_edge_lanes(SEED, E2_TILE)
    etk5, eta5, etb5, etp5, ecut = (torch.from_numpy(x).to(dev)
                                    for x in (etk5, eta5, etb5, etp5, ecut))
    eoff5, ec15, etot5 = X._expand_inputs(etk5, eta5, etp5)
    etot5 = torch.where(ecut >= 0, ecut, etot5)
    args5 = (eoff5, ec15, etb5, etp5, etot5, ecap)
    require(torch.equal(expand_fused2(*args5), expand_fused2_plain(*args5)),
            f"expand_fused2 differs from plain on the edge lanes {enames}")
    for i, lane in enumerate(enames):  # each lane alone, and at a row of 16 bytes more
        for cap in (ecap, ecap + 16 - ecap % 16):
            a = tuple(x[i : i + 1] for x in args5[:5]) + (cap,)
            require(torch.equal(expand_fused2(*a), expand_fused2_plain(*a)),
                    f"expand_fused2 differs from plain on the edge lane {lane} "
                    f"at a row of {cap}")
    log(f"kernel expand_fused2: equal to plain on edge lanes {enames} at a row "
        f"of {ecap} bytes (tiles of {E2_TILE}), together and each alone")
    n_ent = 0
    for T in (32, 256, 8192):
        for kind in ("random", "stops_first", "stops_last", "high"):
            phiP = torch.from_numpy(L.ent_edge_maps(T, kind, SEED + T)).to(dev)
            for p0v in (0, 5, 63, 64):
                p0 = torch.tensor([p0v], dtype=torch.int32, device=dev).reshape(())
                got = ent_from_phi(phiP, p0)
                require(torch.equal(got, ent_from_phi_plain(phiP, p0)),
                        f"ent_from_phi differs from plain at T = {T}, {kind}, "
                        f"p0 = {p0v}")
                n_ent += 1
    log(f"kernel ent_from_phi: equal to plain on {n_ent} edge cases (T = 32, "
        f"256, 8192; orbits that stop in the first and in the last tile, "
        f"entries of 64..190 and 192..255; p0 = 0, 5, 63, 64)")

    # the device-paced decode's other two kernels on every header and block
    # that the -6 and stored-mix -6 decodes above handed them, then on edge
    # lanes and chases built here
    for a in visits:
        require(torch.equal(visited_from_adv(*a), visited_from_adv_plain(*a)),
                "visited_from_adv differs from plain on a header's chase")
    for a in blocks_in:
        err = max_abs_err(tokenize_dyn_hier(*a), tokenize_dyn_hier_plain(*a))
        require(err == 0, f"tokenize_dyn_hier differs from plain on a block by {err}")
    log(f"kernels visited_from_adv and tokenize_dyn_hier: equal to plain on all "
        f"{len(visits)} headers and all {len(blocks_in)} blocks of the -6 and "
        f"stored-mix -6 decodes")

    def k1d_equal(rows, ends, tab, pw) -> bool:
        """K1d's plane and maps against the plain version's."""
        plane, phiP = hier_maps(rows, ends, tab, pw)
        want_plane, want_phiP = hier_maps_plain(rows, ends, tab, pw)
        return (torch.equal(plane.long(), want_plane)
                and torch.equal(phiP, want_phiP))

    for a in blocks_in:
        require(k1d_equal(a[0], a[1], a[2], a[4]),
                "tokenize_dyn_hier's K1d differs from plain on a block")
    k1d_lanes = {f"hier {k}": L.hier_lane(st, F.PW, e, ob)
                 for k, (st, e, ob) in L.hier_edge_streams(KD.K3D_TILES).items()}
    k1d_lanes.update(L.k1d_edge_lanes(F.PW))
    for lname, lane in k1d_lanes.items():
        rows_l, ends_l, tab_l, starts_l = (torch.from_numpy(x).to(dev) for x in lane)
        require(k1d_equal(rows_l, ends_l, tab_l, F.PW),
                f"tokenize_dyn_hier's K1d differs from plain on the lane {lname}")
        if not lname.startswith("hier "):
            hargs = (rows_l, ends_l, tab_l, starts_l, F.PW)
            err = max_abs_err(tokenize_dyn_hier(*hargs), tokenize_dyn_hier_plain(*hargs))
            require(err == 0, f"tokenize_dyn_hier differs from plain on the K1d "
                    f"edge lane {lname} by {err}")
    log(f"tokenize_dyn_hier's K1d: plane and maps equal to plain on all "
        f"{len(blocks_in)} blocks and on edge lanes {sorted(k1d_lanes)} at pw = "
        f"{F.PW}")
    hier_errs = {}
    for lname, (lstream, lend, lbase) in L.hier_edge_streams(KD.K3D_TILES).items():
        hargs = tuple(torch.from_numpy(x).to(dev)
                      for x in L.hier_lane(lstream, F.PW, lend, lbase)) + (F.PW,)
        got = tokenize_dyn_hier(*hargs)
        err = max_abs_err(got, tokenize_dyn_hier_plain(*hargs))
        require(err == 0, f"tokenize_dyn_hier differs from plain on the edge lane "
                f"{lname} by {err}")
        hier_errs[lname] = int(got[6])
    require(hier_errs["far_second_run"] == KT.ERR_DIST
            and hier_errs["bad_code_second_run"] == KT.ERR_BAD_CODE
            and hier_errs["eob_last_tile"] == hier_errs["reach_second_run"]
            == hier_errs["empty_end0"] == KT.ERR_OK, f"hier edge lanes: {hier_errs}")
    visit_cases = L.visit_edge_cases(SEED)
    for vname, (advT, termT, p0v) in visit_cases.items():
        vargs = (torch.from_numpy(advT).to(dev), torch.from_numpy(termT).to(dev),
                 torch.tensor(p0v, dtype=torch.int32, device=dev))
        require(torch.equal(visited_from_adv(*vargs), visited_from_adv_plain(*vargs)),
                f"visited_from_adv differs from plain on the edge case {vname}")
    log(f"kernel tokenize_dyn_hier: equal to plain on edge lanes at pw = {F.PW} "
        f"(errors {hier_errs}); kernel visited_from_adv: equal to plain on edge "
        f"chases {sorted(visit_cases)}")

    def counted(path: str, drive, must):
        """One counted run of a main path: every kernel's count is set to
        0 just before drive() and read just after; the kernels named in
        must have to have launched.  Returns (drive's result, counts)."""
        for r in results:
            r["fn"].launches = 0
        out = drive()
        counts = {r["name"]: r["fn"].launches for r in results}
        for r in results:
            r["launches_by_path"][path] = counts[r["name"]]
        for kname in must:
            require(counts[kname] > 0, f"{kname} never launched on the "
                    f"{path} path; counts {counts}")
        return out, counts

    def round_trip(rcfg):
        """(stream, index, bytes back, encode seconds, decode seconds)."""
        t0 = time.perf_counter()
        zs, zindex = compress_indexed(data, rcfg, device=dev)
        t1 = time.perf_counter()
        zback = decompress_indexed(zs, zindex, rcfg, device=dev)
        return zs, zindex, zback, t1 - t0, time.perf_counter() - t1

    # ---- 4. the main path -----------------------------------------------
    (stream, index, back, enc_s, dec_s), counts = counted(
        "static", lambda: round_trip(cfg),
        ("match_bitplane_batch", "mono_scatter_add", "tokenize_static_batch",
         "expand_fused3"))
    require(zlib.decompress(stream) == data, "zlib rejects the port's stream")
    require(back == data, "decompress_indexed did not return the input")
    require_pinned(stream, PIN_STATIC, "DEFAULT")
    log(f"main path: {len(data)} B -> {len(stream)} B "
        f"(ratio {len(stream) / len(data):.4f}), zlib verified, equal to "
        f"the JAX package's stream; launches {counts}; "
        f"compress_indexed {len(data) / enc_s / 1e9:.4f} GB/s, "
        f"decompress_indexed {len(data) / dec_s / 1e9:.4f} GB/s "
        f"(first call, host clock) on {name}, {smi}")
    enc_ms = cuda_ms(lambda: E.encode_blocks_batch(chunks, lens, finals, cfg), 5)
    esplit = device_split(lambda: E.encode_blocks_batch(chunks, lens, finals, cfg), 5)
    parts = {"match2": 0.0, "mono_scatter_add": 0.0, "memsets": 0.0}
    for k, v in esplit.items():
        part = next((p for p in ("match2", "mono_scatter_add") if p in k), None)
        if part is None and ("memset" in k.lower() or "Fill" in k):
            part = "memsets"
        if part is not None:
            parts[part] += v
    log(f"static encode_blocks_batch, device time by profiler: "
        f"{sum(esplit.values()):.4f} ms, of which match_bitplane_batch "
        f"{parts['match2']:.4f} ms, mono_scatter_add "
        f"{parts['mono_scatter_add']:.4f} ms, memsets and fills "
        f"{parts['memsets']:.4f} ms, the rest "
        f"{sum(esplit.values()) - sum(parts.values()):.4f} ms in "
        f"{len(esplit)} kinds of launch on {name}, {smi}")
    dec_ms = cuda_ms(
        lambda: D.decode_rows_batch(rows, ends, out_cap=chunk, tok_cap=tok_cap), 5
    )
    split = device_split(
        lambda: D.decode_rows_batch(rows, ends, out_cap=chunk, tok_cap=tok_cap), 5)
    tok_dev = sum(v for k, v in split.items() if "tokenize_static" in k)
    exp_dev = sum(v for k, v in split.items() if "expand3" in k)
    log(f"static decode_rows_batch, device time by profiler: "
        f"{sum(split.values()):.4f} ms, of which tokenize_static_batch "
        f"{tok_dev:.4f} ms, expand_fused3 {exp_dev:.4f} ms, the rest "
        f"{sum(split.values()) - tok_dev - exp_dev:.4f} ms in "
        f"{len(split)} kinds of launch on {name}, {smi}")
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
    stream2, index2 = compress_indexed(mixed, cfg, device=dev)
    stored = int((index2 == chunk + 10).sum())  # two stored blocks per chunk
    require(stored >= 3, f"only {stored} stored lanes in the mixed input")
    require(zlib.decompress(stream2) == mixed, "zlib rejects the mixed stream")
    require(decompress_indexed(stream2, index2, cfg, device=dev) == mixed,
            "mixed input did not round-trip")
    log(f"stored lanes: {stored} of {len(index2)} lanes stored, round trip ok")

    # ---- 6. dynamic trees -----------------------------------------------
    (dstream, dindex, dback, enc_s, dec_s), counts = counted(
        "dynamic", lambda: round_trip(dcfg),
        ("match_bitplane_batch", "dyn_trees_batch", "mono_scatter_add", "mono_compact",
         "tokenize_dyn_batch", "expand_fused3"))
    require(zlib.decompress(dstream) == data, "zlib rejects the dynamic stream")
    require(dback == data, "the dynamic stream did not round-trip")
    require_pinned(dstream, PIN_DYNAMIC, "dynamic")
    log(f"dynamic path: {len(data)} B -> {len(dstream)} B "
        f"(ratio {len(dstream) / len(data):.4f}), zlib verified, equal to "
        f"the JAX package's stream; launches {counts}; "
        f"compress_indexed {len(data) / enc_s / 1e9:.4f} GB/s, "
        f"decompress_indexed {len(data) / dec_s / 1e9:.4f} GB/s "
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

    # ---- 7. one zlib stream, one lane, the general pipeline --------------
    def general(zs, want):
        """The general pipeline of decompress: the zlib stream's body from
        bit 16, the block walk over the two tokenizer kernels, then the
        expansion; (output, host seconds)."""
        t0 = time.perf_counter()
        out, total, _end = D._inflate_general(zs, start_bit=16, device=dev)
        require(out[:total].tobytes() == want, "the general pipeline did not "
                "return the input")
        return time.perf_counter() - t0

    stream_s, counts = counted(
        "stream", lambda: general(zs6, data),
        ("mono_compact", "tokenize_dyn_batch", "expand_fused2"))
    blocks = counts["tokenize_dyn_batch"]
    log(f"single stream, zlib -6, general pipeline: {len(zs6)} B -> "
        f"{len(data)} B, {blocks} dynamic blocks, {stream_s:.3f} s = "
        f"{len(data) / stream_s / 1e9:.5f} GB/s (host clock, with transfers) "
        f"on {name}, {smi}; launches {counts}")
    # stored tokens in a long stream: its segments take the resolve route
    mix_s, counts = counted(
        "stream_stored_mix", lambda: general(zmix6, mixed),
        ("mono_compact", "tokenize_static_batch", "tokenize_dyn_batch",
         "resolve_roots", "expand_fused2"))
    log(f"single stream, stored-mix -6, general pipeline: {len(zmix6)} B -> "
        f"{len(mixed)} B in {mix_s:.3f} s (host clock); launches {counts} on "
        f"{name}, {smi}")

    # where that time goes: each stage closed by a synchronize
    spent = {}

    def timed(module, fname):
        fn = getattr(module, fname)

        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[fname] = spent.get(fname, 0.0) + time.perf_counter() - t
            return out

        setattr(module, fname, wrapper)
        return fn

    def staged_run(staged, drive):
        """Host seconds of drive() and of each staged function in it."""
        spent.clear()
        originals = [timed(m, f) for m, f in staged]
        t0 = time.perf_counter()
        drive()
        whole = time.perf_counter() - t0
        for (m, f), fn in zip(staged, originals):
            setattr(m, f, fn)
        return whole

    whole = staged_run(
        [(D, "tokenize"), (D, "dyn_header_params_batch"),
         (D, "tokenize_dyn_batch"), (F, "expand_segments"), (F, "expand_batch")],
        lambda: general(zs6, data))
    log("single stream, zlib -6, general pipeline, stages (host clock, "
        f"synchronized): whole {whole:.3f} s; walk {spent['tokenize']:.3f} s, "
        f"of which header parse {spent['dyn_header_params_batch']:.3f} s and "
        f"dynamic kernel {spent['tokenize_dyn_batch']:.3f} s; expansion "
        f"{spent['expand_segments']:.3f} s, of which expand_batch "
        f"{spent['expand_batch']:.3f} s on {name}, {smi}")

    # ---- 7b. one zlib stream, the device-paced decode -----------------------
    served = []
    inflate_foreign = D.inflate_foreign_device

    def spy_foreign(*a, **kw):
        served.append(inflate_foreign(*a, **kw))
        return served[-1]

    D.inflate_foreign_device = spy_foreign

    def foreign(zs, want, zcfg=DEFAULT):
        """decompress on the card: (host seconds, whether the device-paced
        decode served it)."""
        served.clear()
        t0 = time.perf_counter()
        require(decompress(zs, zcfg, device=dev) == want,
                "decompress did not return the input")
        took = time.perf_counter() - t0
        return took, len(served) == 1 and served[0] is not None

    path = ("ent_from_phi", "visited_from_adv", "tokenize_dyn_hier",
            "mono_compact", "expand_fused2")
    (fs, ok), counts = counted("foreign", lambda: foreign(zs6, data), path)
    require(ok, "the -6 stream fell back to the general pipeline")
    require(counts["tokenize_dyn_batch"] == 0, "the block-per-lane dynamic kernel ran")
    require(counts["visited_from_adv"] == counts["ent_from_phi"]
            == counts["tokenize_dyn_hier"] == blocks,
            f"not one launch of each a dynamic block ({blocks}): {counts}")
    log(f"single stream, zlib -6, device-paced: {len(zs6)} B -> {len(data)} B, "
        f"{blocks} dynamic blocks, {fs:.3f} s = {len(data) / fs / 1e9:.5f} "
        f"GB/s (host clock, with transfers and the Adler check) on {name}, "
        f"{smi}; launches {counts}")
    for label, level in (("foreign_stored_mix", 6), ("foreign_stored_mix0", 0)):
        zs = zmix6 if level == 6 else zlib.compress(mixed, 0)
        (fs, ok), counts = counted(
            label, lambda: foreign(zs, mixed),
            ("resolve_roots",) + (path if level == 6 else ()))
        require(ok, f"the stored-mix -{level} stream fell back")
        log(f"single stream, stored-mix -{level}, device-paced: {len(zs)} B -> "
            f"{len(mixed)} B in {fs:.3f} s (host clock); launches {counts} on "
            f"{name}, {smi}")
    for what, zs, want, zcfg, paced in (
        ("own static stream", stream, data, DEFAULT, True),
        ("own static stream, dynamic=False", stream, data,
         DeflateConfig(dynamic=False), False),
        ("own dynamic stream", dstream, data, DEFAULT, True),
    ):
        fs, ok = foreign(zs, want, zcfg)
        require(ok == paced, f"{what}: device-paced {ok}, expected {paced}")
        log(f"single stream, {what}: {len(zs)} B -> {len(want)} B in "
            f"{fs:.3f} s (host clock, {'device-paced' if ok else 'general'}) "
            f"on {name}, {smi}")
    # a 1-bit literal code: the lane tokenizer walks those blocks, within
    # the device-paced decode
    skew = bytes(3 << 18) + data[: 1 << 18]
    co = zlib.compressobj(9, zlib.DEFLATED, 15, 8, zlib.Z_HUFFMAN_ONLY)
    zskew = co.compress(skew) + co.flush()
    (fs, ok), counts = counted("foreign_one_bit", lambda: foreign(zskew, skew),
                               ("tokenize_dyn_batch",) + path)
    require(ok, "the Z_HUFFMAN_ONLY stream fell back to the general pipeline")
    require(counts["tokenize_dyn_batch"] >= 48,
            f"the 1-bit blocks did not take the lane tokenizer: {counts}")
    log(f"single stream, Z_HUFFMAN_ONLY with 1-bit codes: device-paced, the "
        f"1-bit blocks through the lane tokenizer, {fs:.3f} s (host clock), "
        f"equal to the input; launches {counts}")
    try:
        decompress(dstream, DeflateConfig(dynamic=False), device=dev)
        require(False, "dynamic=False decoded a dynamic stream")
    except DeflateError:
        pass
    broken = bytearray(zs6)
    broken[len(broken) // 2] ^= 0x10
    try:
        decompress(bytes(broken), device=dev)
        require(False, "a corrupt stream decoded")
    except DeflateError as e:
        log(f"single stream, corrupt: DeflateError({e})")
    D.inflate_foreign_device = inflate_foreign

    # a dynamic header's parse is one replay of its graph (the replays'
    # time), a static header's pack_block_tab alone
    whole = staged_run(
        [(F._HeaderGraph, "__call__"), (F, "pack_block_tab"),
         (F, "tokenize_dyn_hier"), (F, "expand_segments"), (F, "expand")],
        lambda: foreign(zs6, data))
    parse = spent.get("__call__", 0.0) + spent.get("pack_block_tab", 0.0)
    expansion = spent.get("expand_segments", 0.0) + spent.get("expand", 0.0)
    log("single stream, zlib -6, device-paced, stages (host clock, "
        f"synchronized): whole {whole:.3f} s; header parse {parse:.3f} s "
        f"(graph replays {spent.get('__call__', 0.0):.3f} s); tile-parallel "
        f"tokenizer {spent['tokenize_dyn_hier']:.3f} s; expansion "
        f"{expansion:.3f} s; the rest (host loop, window gather, token "
        f"appends, transfers, Adler check) "
        f"{whole - parse - expansion - spent['tokenize_dyn_hier']:.3f} s on "
        f"{name}, {smi}")

    # ---- 8. long rows -----------------------------------------------------
    lcfg = DeflateConfig(chunk_size=1 << 20)
    long_path = [
        (E, "match_bitplane_batch", match_bitplane_plain),
        (E, "mono_scatter_add", mono_scatter_add_plain),
        (D, "tokenize_static_batch", tokenize_static_plain),
        (X, "expand_fused2", expand_fused2_plain),
    ]
    seen = [[] for _ in long_path]
    originals = [capture(m, f, calls) for (m, f, _), calls in zip(long_path, seen)]
    (lstream, lindex, lback, enc_s, dec_s), counts = counted(
        "long_rows", lambda: round_trip(lcfg), [f for _, f, _ in long_path])
    for (m, f, _), fn in zip(long_path, originals):
        setattr(m, f, fn)
    require(len(lindex) == 8, f"{len(lindex)} long rows")
    require(zlib.decompress(lstream) == data, "zlib rejects the long-row stream")
    require(lback == data, "the long rows did not round-trip")
    log(f"long rows: {len(data)} B in {len(lindex)} chunks of 1 MiB -> "
        f"{len(lstream)} B, zlib verified; compress_indexed {enc_s:.3f} s, "
        f"decompress_indexed {dec_s:.3f} s (host clock); launches {counts} "
        f"on {name}, {smi}")
    # each kernel call of that run again, against its plain version
    for (_, f, plain), fn, calls in zip(long_path, originals, seen):
        require(len(calls) >= 1, f"no call of {f} on the long rows")
        args = calls[0]
        require(args[0].shape[0] == 8, f"{f}: {args[0].shape[0]} lanes")
        got, want = fn(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        require(err == 0, f"{f} differs from its plain version on the long "
                f"rows by {err}")
        ms = cuda_ms(lambda: fn(*args), reps=3)
        dev_ms = device_ms(lambda: fn(*args), reps=3)
        extra = ""
        if f == "expand_fused2":
            chase = expand2_chain(args, E2_TILE)
            extra = (f"; bound {bound(*work_expand(args[3], args[4], got[0]))[0]:.5f}"
                     f" ms by bytes, serial {chase * L2_CYCLES / SM_HZ * 1e3:.5f}"
                     f" ms (a chase of {chase} steps)")
        log(f"kernel {f} on the long rows: equal to plain on 8 lanes of "
            f"{tuple(args[0].shape[1:])}; device {fmt_ms(dev_ms)}, "
            f"host-paced {ms:.4f} ms{extra} on {name}, {smi}")
    require(seen[3][0][5] == 1 << 20, f"long-row expansion at {seen[3][0][5]}")

    # ---- 9. gzip and streaming ------------------------------------------
    t9 = time.perf_counter()
    steps = {"calls": 0, "waits": 0}
    stream_step = A.inflate_stream_step

    def counted_step(*a, **kw):
        out = stream_step(*a, **kw)
        steps["calls"] += 1
        steps["waits"] += out == (b"", 0, False)
        return out

    def checked(path: str, drive, must, keep: int = 1):
        """``held_run`` with the stream steps counted and the launches
        recorded in launches_by_path.  Returns (drive's result, counts,
        calls held)."""
        steps.update(calls=0, waits=0)
        A.inflate_stream_step = counted_step
        try:
            out, counts, held, _ = held_run(path, drive, must, keep)
        finally:
            A.inflate_stream_step = stream_step
        for r in results:
            r["launches_by_path"][path] = counts[r["name"]]
        return out, counts, held

    def median_spread(fn, first: float):
        """Median and spread (max - min) of host seconds: ``first`` and
        two more runs of fn."""
        runs = [first]
        for _ in range(2):
            t = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t)
        return sorted(runs)[1], max(runs) - min(runs)

    def host_s(fn):
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t

    def feed(dec, stream, step):
        return b"".join(dec.decompress(stream[i : i + step])
                        for i in range(0, len(stream), step)) + dec.flush()

    new_runs = {}
    # self-indexing members: the encoder, then the members as lanes
    def members_run():
        g = compress_gzip_members(data, cfg, device=dev)
        return g, host_s(lambda: decompress_gzip(g, cfg, device=dev))

    (members, (back, dec_s)), counts, held = checked(
        "gzip_members", members_run,
        ("match_bitplane_batch", "mono_scatter_add", "tokenize_static_batch",
         "expand_fused3"))
    new_runs["gzip_members"] = counts
    require(back == data, "decompress_gzip did not return the input")
    require(gzip.decompress(members) == data, "gzip rejects the members")
    require_pinned(members, PIN_GZIP_MEMBERS, "compress_gzip_members")
    med, spread = median_spread(lambda: decompress_gzip(members, cfg, device=dev), dec_s)
    log(f"gzip members: {len(data)} B -> {len(members)} B in {len(index)} members, "
        f"gzip verified, equal to the JAX package's; decompress_gzip median "
        f"{med:.4f} s, spread {spread:.4f} s of 3 (host clock); {held} kernel "
        f"calls equal to plain; launches {counts} on {name}, {smi}")

    # one foreign member: the device-paced decode from the member's body
    gz6 = gzip.compress(data, 6)
    (back, dec_s), counts, held = checked(
        "gzip_foreign", lambda: host_s(lambda: decompress_gzip(gz6, device=dev)), path)
    new_runs["gzip_foreign"] = counts
    require(back == data, "decompress_gzip of gzip -6 did not return the input")
    require(counts["visited_from_adv"] == counts["tokenize_dyn_hier"] == blocks,
            f"gzip -6: not one launch a dynamic block ({blocks}): {counts}")
    med, spread = median_spread(lambda: decompress_gzip(gz6, device=dev), dec_s)
    log(f"gzip -6, one member: {len(gz6)} B -> {len(data)} B device-paced, "
        f"median {med:.4f} s, spread {spread:.4f} s of 3 (host clock); {held} "
        f"kernel calls equal to plain; launches {counts} on {name}, {smi}")

    # eight foreign members of 1 MiB: each decoded from its bit in the buffer
    gz8 = b"".join(gzip.compress(data[i : i + (1 << 20)], 6)
                   for i in range(0, SIZE, 1 << 20))
    (back, dec_s), counts, held = checked(
        "gzip_foreign_members", lambda: host_s(lambda: decompress_gzip(gz8, device=dev)),
        path)
    new_runs["gzip_foreign_members"] = counts
    require(back == data, "decompress_gzip of 8 members did not return the input")
    med, spread = median_spread(lambda: decompress_gzip(gz8, device=dev), dec_s)
    log(f"gzip -6, 8 members of 1 MiB: {len(gz8)} B -> {len(data)} B "
        f"device-paced, median {med:.4f} s, spread {spread:.4f} s of 3 (host "
        f"clock); {held} kernel calls equal to plain; launches {counts} on "
        f"{name}, {smi}")

    # the zlib -6 stream through StreamDecompressor in 64 KiB slices: a step
    # a Huffman block, each after the first carrying a 32 KiB window
    (back, dec_s), counts, held = checked(
        "stream_zlib6",
        lambda: host_s(lambda: feed(StreamDecompressor(DEFAULT, device=dev), zs6,
                                    1 << 16)),
        ("tokenize_static_batch", "mono_compact", "tokenize_dyn_batch",
         "resolve_roots"), keep=2)
    new_runs["stream_zlib6"] = counts
    require(back == data, "StreamDecompressor of zlib -6 did not return the input")
    nsteps, nwaits = steps["calls"], steps["waits"]
    require(nsteps - nwaits == blocks, f"{nsteps - nwaits} steps that decoded, "
            f"{blocks} blocks")
    med, spread = median_spread(
        lambda: feed(StreamDecompressor(DEFAULT, device=dev), zs6, 1 << 16), dec_s)
    log(f"StreamDecompressor, zlib -6 in slices of 64 KiB: {len(zs6)} B -> "
        f"{len(data)} B in {nsteps} steps, {nwaits} of them (b'', 0, False); "
        f"median {med:.4f} s, spread {spread:.4f} s of 3 (host clock); {held} "
        f"kernel calls equal to plain (the first two of each: the static "
        f"tokenizer from the synthetic stored block with stop_at_eob, "
        f"resolve_roots with and without a 32 KiB window); launches {counts} "
        f"on {name}, {smi}")
    every = {k for c in new_runs.values() for k, v in c.items() if v}
    # every kernel but the encode's of the full window and dynamic trees
    # (phases 6 and 10); the new runs compress with static trees
    kernels9 = {r["name"] for r in results} - {"far_match_batch", "dyn_trees_batch"}
    require(every == kernels9, f"kernels that launched or not on the new "
            f"runs: {sorted(every ^ kernels9)}")

    # outside the counts: the port's own stream, the start of -6 in 4 KiB
    # slices, StreamCompressor, compress_gzip, gzip header fields, FALLBACK
    back = feed(StreamDecompressor(DEFAULT, device=dev), stream, 1 << 20)
    require(back == data, "StreamDecompressor of the port's stream differs")
    z1 = zlib.compress(data[: 1 << 20], 6)
    steps.update(calls=0, waits=0)
    A.inflate_stream_step = counted_step
    back = feed(StreamDecompressor(DEFAULT, device=dev), z1, 4096)
    A.inflate_stream_step = stream_step
    require(back == data[: 1 << 20], "StreamDecompressor of 1 MiB at -6 differs")
    log(f"StreamDecompressor: the port's own stream in 1 MiB slices, and zlib "
        f"-6 of 1 MiB in 4 KiB slices ({steps['calls']} steps, "
        f"{steps['waits']} of them (b'', 0, False)), equal to the input")
    comp = StreamCompressor(DEFAULT, device=dev)
    sc = b"".join(comp.compress(data[i : i + 1000003])
                  for i in range(0, SIZE, 1000003)) + comp.flush()
    require(zlib.decompress(sc) == data, "zlib rejects StreamCompressor's stream")
    require_pinned(sc, PIN_STREAM, "StreamCompressor")
    gz1 = compress_gzip(data, cfg, device=dev)
    require(gz1[10:-8] == stream[2:-4] and gzip.decompress(gz1) == data,
            "compress_gzip's body is not the pinned DEFAULT stream's")
    log("StreamCompressor in slices of 1000003 B: zlib verified, equal to the "
        "JAX package's; compress_gzip: the body of the pinned DEFAULT stream, "
        "gzip verified")
    text = data[: 300000]

    def member(payload, flags, level=6, strategy=zlib.Z_DEFAULT_STRATEGY,
               fields=b""):
        head = b"\x1f\x8b\x08" + bytes([flags]) + bytes(4) + b"\x00\xff" + fields
        if flags & 0x02:
            head += (zlib.crc32(head) & 0xFFFF).to_bytes(2, "little")
        co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
        return (head + co.compress(payload) + co.flush()
                + zlib.crc32(payload).to_bytes(4, "little")
                + len(payload).to_bytes(4, "little"))

    fields = member(text[:100000], 0x08, fields=b"a.txt\x00") + member(
        text[100000:], 0x1E, 9, fields=b"\x02\x00xyb.txt\x00a comment\x00")
    require(gzip.decompress(fields) == text
            and decompress_gzip(fields, device=dev) == text,
            "gzip members with FNAME, FCOMMENT, FEXTRA, FHCRC did not decode")
    served.clear()
    D.inflate_foreign_device = spy_foreign
    skewed = member(skew, 0, 9, zlib.Z_HUFFMAN_ONLY) + member(text, 0)
    back = decompress_gzip(skewed, device=dev)
    D.inflate_foreign_device = inflate_foreign
    require(back == skew + text and gzip.decompress(skewed) == back,
            "a gzip member that falls back did not decode")
    require([x is None for x in served] == [False, False],
            f"FALLBACK on the members: {[x is None for x in served]}")
    log(f"decompress_gzip: members with FNAME, FCOMMENT, FEXTRA and FHCRC, and a "
        f"member with 1-bit literal codes (the lane tokenizer's blocks) before "
        f"another, device-paced, equal to gzip; phase 9 took "
        f"{time.perf_counter() - t9:.1f} s (host clock)")

    # ---- 10. full window ------------------------------------------------
    t10 = time.perf_counter()
    fw_runs = (
        ("full_window", FULL_WINDOW, PIN_FULL_WINDOW,
         ("far_match_batch", "dyn_trees_batch", "mono_scatter_add", "mono_compact",
          "tokenize_dyn_batch", "expand_fused3")),
        ("full_fast", DeflateConfig(window=32768, max_match=258, lazy=True,
                                    chunk_size=1 << 16, far_matcher="fast"),
         PIN_FULL_FAST, ("mono_scatter_add", "tokenize_static_batch", "expand_fused3")),
        ("best_ratio", DeflateConfig(window=32768, max_match=258, lazy=True,
                                     dynamic_encode=True, chunk_size=1 << 18),
         PIN_BEST_RATIO,
         ("far_match_batch", "dyn_trees_batch", "mono_scatter_add", "mono_compact",
          "tokenize_dyn_batch", "expand_fused2")),
    )
    for path_name, fcfg, pin, must in fw_runs:
        (fstream, findex, fback, enc_s, dec_s), counts, held = checked(
            path_name, lambda: round_trip(fcfg), must)
        require(fback == data, f"{path_name}: decompress_indexed did not return the input")
        require(zlib.decompress(fstream) == data, f"zlib rejects the {path_name} stream")
        require_pinned(fstream, pin, path_name)
        require((counts["far_match_batch"] > 0) == (fcfg.far_matcher == "exact"),
                f"{path_name}: far_match_batch launched {counts['far_match_batch']} times")
        if path_name == "full_window":
            back, fw_dec_s = host_s(lambda: decompress(fstream, device=dev))
            require(back == data, "decompress of the full-window stream differs")
            log(f"full_window: decompress without the index (device-paced) "
                f"{fw_dec_s:.4f} s (host clock, first call)")
        C = fcfg.chunk_size
        fchunks = chunks.reshape(SIZE // C, C)
        flens = torch.full((SIZE // C,), C, dtype=torch.int32, device=dev)
        ffinals = torch.zeros(SIZE // C, dtype=torch.bool, device=dev)
        ffinals[-1] = True

        def encode():
            return E.encode_blocks_batch(fchunks, flens, ffinals, fcfg)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        encode()
        peak = torch.cuda.max_memory_allocated() - base
        ev_ms = cuda_ms(encode, 3)
        split = device_split(encode, 3)
        msplit = device_split(lambda: E._match(fchunks, flens, fcfg), 3)
        matcher_ms = sum(msplit.values())
        top = sorted(msplit.items(), key=lambda kv: -kv[1])[:4]
        pack_ms = sum(v for k, v in split.items() if "mono_scatter" in k)
        dev_total = sum(split.values())
        log(f"{path_name}: {len(data)} B -> {len(fstream)} B in {len(findex)} "
            f"chunks of {C} B, ratio {len(fstream) / len(data):.4f}, "
            f"{len(fstream) / len(zs6):.4f}x zlib -6's {len(zs6)} B; zlib "
            f"verified, equal to the JAX package's; {held} kernel calls equal "
            f"to plain; launches {counts}; compress_indexed {enc_s:.4f} s, "
            f"decompress_indexed {dec_s:.4f} s (host clock, first call); "
            f"encode_blocks_batch {ev_ms:.3f} ms = {SIZE / ev_ms / 1e6:.4f} GB/s "
            f"by CUDA events, {dev_total:.3f} ms = {SIZE / dev_total / 1e6:.4f} "
            f"GB/s device time by the profiler: the match stage ("
            f"{'the far_match_batch kernels and their sort' if fcfg.far_matcher == 'exact' else 'the fast far matcher glue'}"
            f") {matcher_ms:.3f} ms (its own run, {len(msplit)} kinds of launch, "
            f"led by " + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top) + "), "
            f"the bit-pack {pack_ms:.4f} ms, "
            f"the rest {dev_total - matcher_ms - pack_ms:.3f} ms, in {len(split)} "
            f"kinds of launch; peak device memory of one encode {peak / 2**30:.2f} "
            f"GiB above the {base / 2**30:.2f} GiB held before it, on {name}, {smi}")

    # outside the counts: the self-test, the CLI, the profiler
    require(run_selftest(device=dev), "run_selftest failed on the card")
    work = os.path.join(REPO, "build", "phase10")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "in.bin")
    with open(src, "wb") as f:
        f.write(data[: 1 << 20])
    for level in ("fast", "ref", "max"):
        for gz in (False, True):
            packed = src + (".gz" if gz else ".zz")
            require(cli_main([src, "--level", level] + ["--gzip"] * gz) == 0,
                    f"the CLI failed at {level}")
            with open(packed, "rb") as f:
                comp = f.read()
            require((gzip.decompress(comp) if gz else zlib.decompress(comp))
                    == data[: 1 << 20], f"the CLI's {level} stream differs")
        back = os.path.join(work, "back.bin")
        require(cli_main([src + ".zz", "-d", "-o", back, "--level", level]) == 0,
                f"the CLI failed to decompress at {level}")
        with open(back, "rb") as f:
            require(f.read() == data[: 1 << 20], f"the CLI's {level} round trip differs")
    # the module as a user runs it, in a process of its own
    for argv in ([src, "-o", src + ".m.zz"], [src + ".m.zz", "-d", "-o", src + ".m"]):
        subprocess.run([sys.executable, "-m", "tpu_deflate_torch", *argv],
                       cwd=REPO, check=True, timeout=300)
    with open(src + ".m", "rb") as f:
        require(f.read() == data[: 1 << 20], "python -m tpu_deflate_torch differs")
    prof = Profiler(device=dev)
    trace_dir = os.path.join(work, "trace")
    with device_trace(trace_dir, device=dev):
        with prof.stage("compress_full_window", nbytes=SIZE):
            fw = compress(data, FULL_WINDOW, device=dev)
    with prof.stage("decompress_full_window", nbytes=SIZE):
        require(decompress(fw, device=dev) == data, "decompress of compress's stream")
    report = json.loads(prof.report())
    traces = [p for p in os.listdir(trace_dir) if p.endswith(".json")]
    require([sorted(r) for r in report] == [["GB/s", "bytes", "calls", "name", "seconds"]] * 2
            and len(traces) == 1, f"profiler report {report}, traces {traces}")
    log(f"run_selftest passed on the card; the CLI at fast, ref and max "
        f"(zlib, gzip and -d, and python -m tpu_deflate_torch at max) on 1 MiB "
        f"verified by zlib and gzip; Profiler (CUDA events) {prof.report()}; "
        f"device_trace wrote {traces[0]} ({os.path.getsize(os.path.join(trace_dir, traces[0]))} B); "
        f"phase 10 took {time.perf_counter() - t10:.1f} s (host clock)")
    shutil.rmtree(work)

    # ---- 11. sharding ---------------------------------------------------
    import numpy as np

    from tpu_deflate_torch.dryrun import dryrun_multichip
    from tpu_deflate_torch.parallel import shard as S

    t11 = time.perf_counter()
    world = torch.cuda.device_count()
    work = os.path.join(REPO, "build", "phase11")
    os.makedirs(work, exist_ok=True)
    reports = run_ranks(world, work)
    for path, _, _, _ in SHARD_RUNS:
        runs = [rep["runs"][path] for rep in reports]
        for r in results:
            r["launches_by_path"][path] = sum(run["counts"][r["name"]] for run in runs)
        counts = {r["name"]: r["launches_by_path"][path] for r in results}
        for rank, run in enumerate(runs):
            host = sorted(run["host_s"])
            log(f"{path}: world {world}, rank {rank} ({reports[rank]['device']}): "
                f"{run['lanes']} lanes, stream {run['bytes']} B, zlib verified"
                f"{', equal to the JAX package' if path != 'sharded_long' else ', equal to compress'}"
                f"'s, decode_sharded returned the input; encode_sharded + "
                f"assemble_ragged + gather + decode_sharded median {host[1]:.4f} s, "
                f"spread {host[-1] - host[0]:.4f} s of 3 (host clock); device time "
                f"by the profiler: encode {run['encode_device_ms']:.3f} ms, decode "
                f"{run['decode_device_ms']:.3f} ms; {run['held']} kernel calls "
                f"equal to plain on {name}, {smi}")
        log(f"{path}: launches over {world} rank(s) {counts}")

    # in this process: a mesh that lists the card four times, no group
    mesh4 = S.make_mesh([dev] * 4)
    require(mesh4.group is None and mesh4.size == 4, f"mesh {mesh4}")

    def mesh4_run():
        out, sizes, adler = S.encode_sharded(chunks, lens, finals, mesh4, cfg)
        body, total = S.assemble_ragged(out, sizes, out.numel())
        whole = body[: int(total)].cpu().numpy().tobytes()
        offs = 8 * np.concatenate([[0], np.cumsum(sizes.cpu().numpy())])
        got = S.decode_sharded(padded(whole), offs[:-1].astype(np.int32),
                               offs[1:].astype(np.int32), mesh4, chunk,
                               static_only=True)
        return b"\x78\x9c" + whole + int(adler).to_bytes(4, "big"), offs, got

    ((stream4, offs4, (outs4, totals4, errs4)), first), counts, held = checked(
        "sharded_mesh4", lambda: host_s(mesh4_run), SHARD_RUNS[0][3])
    require_pinned(stream4, PIN_STATIC, "the four-entry mesh's")
    require(int(errs4.ne(0).sum()) == 0 and torch.equal(outs4, chunks),
            "decode_sharded over the four-entry mesh did not return the input")
    med, spread = median_spread(mesh4_run, first)
    mesh1 = S.make_mesh([dev])
    enc_ms = {k: sum(device_split(lambda: S.encode_sharded(
        chunks, lens, finals, m, cfg), 1).values()) for k, m in (("4", mesh4), ("1", mesh1))}
    log(f"sharded_mesh4: a mesh of {dev} four times in one process: the "
        f"DEFAULT stream again ({len(stream4)} B, equal to the JAX package's), "
        f"decode_sharded returned the input; median {med:.4f} s, spread "
        f"{spread:.4f} s of 3 (host clock); encode_sharded's device time by "
        f"the profiler {enc_ms['4']:.3f} ms over the four entries, "
        f"{enc_ms['1']:.3f} ms over one; {held} kernel calls equal to plain; "
        f"launches {counts} on {name}, {smi}")

    # outside the counts: every lane 3 bits into its byte (a body after 3
    # bits of zeros) decodes as at bit 0, on the static kernel's resume path
    body4 = stream4[2:-4]
    bits = np.concatenate([np.zeros(3, np.uint8), np.unpackbits(
        np.frombuffer(body4, np.uint8), bitorder="little")])
    shifted = np.packbits(bits, bitorder="little").tobytes()
    sgot = S.decode_sharded(padded(shifted), (offs4[:-1] + 3).astype(np.int32),
                            (offs4[1:] + 3).astype(np.int32), S.make_mesh([dev]),
                            chunk, static_only=True)
    # a stored lane's payload starts at a byte boundary, which moved
    huff = torch.tensor([(body4[o] >> 1) & 3 != 0 for o in offs4[:-1] // 8],
                        device=dev)
    require(all(torch.equal(a[huff], b[huff])
                for a, b in zip(sgot, (outs4, totals4, errs4))),
            "decode_sharded of the body 3 bits on differs")
    log(f"decode_sharded: the {int(huff.sum())} Huffman lanes of {len(index)} "
        f"3 bits into their bytes decode as at bit 0 (the static tokenizer "
        f"resumed at bit 3)")

    (_, dry_s), counts, held = checked(
        "dryrun", lambda: host_s(lambda: dryrun_multichip(world)),
        ("match_bitplane_batch", "mono_scatter_add", "mono_compact",
         "tokenize_static_batch", "tokenize_dyn_batch", "expand_fused3"))
    log(f"dryrun_multichip({world}) passed in {dry_s:.2f} s (host clock); "
        f"{held} kernel calls equal to plain; launches {counts}; phase 11 took "
        f"{time.perf_counter() - t11:.1f} s (host clock) on {name}, {smi}")
    shutil.rmtree(work)

    for r in results:
        r["launches"] = r["launches_by_path"][OWN_PATH[r["name"]]]
        require(r["launches"] > 0, f"{r['name']} never launched on its own path")
    for r in results:
        r.pop("fn")
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        shard_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    else:
        main()
