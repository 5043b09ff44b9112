"""The control, the weaker parses and the planted faults, each in the
program's place, and the calibration that reads the checks' numbers on
many seeds in one process.

    python -m portbench.control --workload <cell> --seconds <s> \\
        --seeds <n ...> [--control-seeds <n ...>] [--faults] \\
        [--weaker <field>=<value> ...]

prints one JSON line a run: the program on ``--seeds``, the control on
``--control-seeds``, with ``--faults`` each planted fault on the first of
``--control-seeds``, and with ``--weaker`` the program with each field of
the configuration changed so (``far_matcher=fast``, ``lazy=false``) on
every one of ``--control-seeds``.  The benchmark's own runs never run any
of these.

The control breaks a guarantee the configuration states, as the step that
would tempt a later change does: stock zlib (level 6) with one window
across the chunks.  Each chunk ends in a sync flush, the empty stored
block the port's lanes end in too, so stream and index look alike, but a
lane's matches reach into the chunk before it (and past the 256-byte
window, 10-byte matches and static trees of ``w256-static``).  A weaker
parse keeps every guarantee but the ratio: it sets the upper reading of
``ratio``.
"""

from __future__ import annotations

import argparse
import json
import sys
import zlib

import numpy as np

from portbench import manifest


class _Instead:
    """The program, with some of its calls replaced."""

    def __init__(self, port):
        self.port = port

    def config(self, fields):
        return self.port.config(fields)

    def __getattr__(self, name):
        if name == "port":
            raise AttributeError(name)
        return getattr(self.port, name)


class SharedWindow(_Instead):
    """The control: stock zlib with one window across chunks."""

    def compress_indexed(self, data, config):
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        C = config.chunk_size
        lanes = []
        for s in range(0, max(len(data), 1), C):
            last = s + C >= len(data)
            lanes.append(c.compress(data[s:s + C])
                         + c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH))
        body = b"".join(lanes)
        stream = b"\x78\x9c" + body + zlib.adler32(data).to_bytes(4, "big")
        return stream, np.array([len(x) for x in lanes], np.int64)


class Weaker(_Instead):
    """The program with fields of the configuration changed."""

    def __init__(self, port, changes: dict):
        super().__init__(port)
        self.changes = changes

    def config(self, fields):
        return self.port.config({**fields, **self.changes})


class Unchanged(_Instead):
    """A step that returns its input unchanged."""

    def compress_indexed(self, data, config):
        return data, np.array([len(data) - 6], np.int64)


class HalfBatch(_Instead):
    """Half of the chunks left out."""

    def compress_indexed(self, data, config):
        return self.port.compress_indexed(data[: len(data) // 2], config)


class Altered(_Instead):
    """One byte of each answer altered where it is produced."""

    def compress_indexed(self, data, config):
        stream, index = self.port.compress_indexed(data, config)
        at = len(stream) // 2
        return stream[:at] + bytes([stream[at] ^ 0x20]) + stream[at + 1:], index


FAULTS = {"unchanged": Unchanged, "half_batch": HalfBatch, "altered": Altered}


def _field(text: str) -> tuple:
    key, value = text.split("=", 1)
    try:
        return key, json.loads(value)
    except ValueError:
        return key, value


def main(argv=None) -> int:
    from portbench.program import Port
    from portbench.run import log, pin_caches, process_start, run_cell

    ap = argparse.ArgumentParser(description="read the checks' numbers")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--weaker", type=_field, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    pin_caches()
    cell = manifest.cell(args.workload)
    port = Port(args.device)
    cuda = args.device == "cuda"
    runs = [("program", s, port) for s in args.seeds]
    runs += [("control", s, SharedWindow(port)) for s in args.control_seeds]
    if args.faults:
        runs += [(name, args.control_seeds[0], f(port)) for name, f in FAULTS.items()]
    for key, value in args.weaker:
        runs += [(f"{key}={value}", s, Weaker(port, {key: value})) for s in args.control_seeds]
    for role, seed, program in runs:
        r = run_cell(cell, seed, args.seconds, False, program, process_start(), cuda)
        line = {"workload": args.workload, "role": role, "seed": seed,
                "correct": r["correct"], "attempted": r["attempted"],
                "checks": {k: v for k, (v, _) in r["checks"].items()},
                "metrics": {k: m["value"] for k, m in r["metrics"].items()}}
        print(json.dumps(line), flush=True)
        log(role, seed, "correct" if r["correct"] else "NOT correct")
    return 0


if __name__ == "__main__":
    sys.exit(main())
