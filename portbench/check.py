"""Whether what the timed path produced is correct.

The judged answers of a compress window are its sample (drawn from the
seed, see ``loop.Traffic.run``) and the last answer of each payload;
answers equal byte for byte are judged once.  A compress answer is a zlib
stream and its index; it is right where

  frames_bad     the zlib header, the index (one entry a chunk, covering
                 the body) and the Adler-32 trailer, taken by the
                 reference from the payload, are all right;
  lanes_bad      every lane, cut by the index and decoded alone by stock
                 zlib, gives its chunk of the payload, final where it is
                 the last and ending on its last byte;
  ref_lanes_bad  every lane gives the same through the plain reference
                 (``reference.inflate_lane``), which also reads, on every
                 lane,
  max_dist, max_len, dynamic_blocks
                 against the configuration's stated window, longest match
                 and, where it states static trees, no dynamic block;
  ratio          the compressed bytes of the last answer of each payload
                 over the payloads' bytes, against the configuration's
                 ``limits.ratio``: a parse weaker than the configuration
                 states (a faster matcher, no lazy step) still decodes,
                 and reads here.

Every count has the limit 0; ``max_dist`` and ``max_len`` have the
configuration's own.
"""

from __future__ import annotations

import hashlib
import math
import zlib

from portbench.reference import DYNAMIC, InflateError, adler32, inflate_lane


def _frame_ok(stream: bytes, index, payload: bytes, chunk: int) -> bool:
    if len(stream) < 6:
        return False
    cmf, flg = stream[0], stream[1]
    if cmf & 0x0F != 8 or (cmf << 8 | flg) % 31 or flg & 0x20:
        return False
    if int.from_bytes(stream[-4:], "big") != adler32(payload):
        return False
    nchunks = max(1, -(-len(payload) // chunk))
    return len(index) == nchunks and sum(int(x) for x in index) == len(stream) - 6


def _lanes(stream: bytes, index, payload: bytes, chunk: int):
    """(lane bytes, its chunk of the payload, whether it is the last)."""
    body = stream[2:-4]
    out, at = [], 0
    for i, n in enumerate(index):
        n = int(n)
        out.append((body[at:at + n], payload[i * chunk:(i + 1) * chunk],
                    i == len(index) - 1))
        at += n
    return out


def _zlib_lane_ok(lane: bytes, want: bytes, last: bool) -> bool:
    d = zlib.decompressobj(-15)
    try:
        got = d.decompress(lane) + d.flush()
    except zlib.error:
        return False
    return got == want and d.eof == last and not d.unused_data


class Judge:
    """Counts over the judged streams, and the reference's readings."""

    def __init__(self, config: dict):
        self.deflate = config["deflate"]
        self.chunk = self.deflate["chunk_size"]
        self.n = {"frames_bad": 0, "lanes_bad": 0, "ref_lanes_bad": 0,
                  "max_dist": 0, "max_len": 0, "dynamic_blocks": 0}

    def stream(self, stream: bytes, index, payload: bytes) -> None:
        if not _frame_ok(stream, index, payload, self.chunk):
            self.n["frames_bad"] += 1
            if sum(int(x) for x in index) != len(stream) - 6:
                self.n["lanes_bad"] += max(1, len(index))
                return
        for lane, want, last in _lanes(stream, index, payload, self.chunk):
            self.n["lanes_bad"] += not _zlib_lane_ok(lane, want, last)
            try:
                got = inflate_lane(lane)
            except InflateError:
                self.n["ref_lanes_bad"] += 1
                continue
            if got.data != want or got.final != last or (got.end_bit + 7) // 8 != len(lane):
                self.n["ref_lanes_bad"] += 1
            self.n["max_dist"] = max(self.n["max_dist"], got.max_dist)
            self.n["max_len"] = max(self.n["max_len"], got.max_len)
            self.n["dynamic_blocks"] += got.blocks[DYNAMIC]

    def checks(self) -> dict:
        """Each number with its limit."""
        out = {k: (self.n[k], 0) for k in ("frames_bad", "lanes_bad", "ref_lanes_bad")}
        out["max_dist"] = (self.n["max_dist"], self.deflate["window"])
        out["max_len"] = (self.n["max_len"], self.deflate["max_match"])
        if not self.deflate["dynamic_encode"]:
            out["dynamic_blocks"] = (self.n["dynamic_blocks"], 0)
        return out


def _key(payload: int, stream: bytes, index) -> tuple:
    return payload, hashlib.sha256(stream).hexdigest(), str([int(x) for x in index])


def ratio(last: dict, payloads: list) -> float:
    """Compressed over uncompressed bytes of one answer of each payload;
    infinite where no call returned."""
    if not last:
        return math.inf
    return (sum(len(stream) for stream, _ in last.values())
            / sum(len(payloads[p]) for p in last))


def judge_streams(window, payloads: list, config: dict) -> dict:
    """``{name: (value, limit)}`` for the window's compress answers."""
    j = Judge(config)
    distinct = {}
    for p, (stream, index) in [*window.sample, *window.last.items()]:
        distinct.setdefault(_key(p, stream, index), (p, stream, index))
    for p, stream, index in distinct.values():
        j.stream(stream, index, payloads[p])
    out = j.checks()
    out["ratio"] = (ratio(window.last, payloads), config["limits"]["ratio"])
    return out


def judge(window, traffic, config: dict) -> dict:
    """The window's checks, with the calls that failed; it is correct
    where every value is at most its limit."""
    return {"calls_failed": (window.failed, 0), **traffic.call.judge(window, config)}


def correct(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())
