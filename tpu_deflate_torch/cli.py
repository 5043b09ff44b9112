"""Command-line interface: gzip-like compress and decompress on the card.

Usage:
    python -m tpu_deflate_torch [-d] [-o OUT] [--gzip] [--level fast|ref|max]
                                [--device DEVICE] FILE
    python -m tpu_deflate_torch --selftest [--device DEVICE]
"""

from __future__ import annotations

import argparse
import sys
import time


def _config(level: str):
    from tpu_deflate_torch.config import DeflateConfig

    if level == "fast":
        return DeflateConfig(fast=True, chunk_size=1 << 16)
    if level == "ref":
        return DeflateConfig(window=256, max_match=10, chunk_size=1 << 16)
    return DeflateConfig(
        window=32768, max_match=258, chunk_size=1 << 16,
        lazy=True, dynamic_encode=True,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_deflate_torch", description=__doc__)
    ap.add_argument("file", nargs="?", help="input file (- for stdin)")
    ap.add_argument("-d", "--decompress", action="store_true")
    ap.add_argument("-o", "--output", help="output file (default: FILE.zz / stripped)")
    ap.add_argument("--gzip", action="store_true", help="gzip container")
    ap.add_argument("--level", choices=["fast", "ref", "max"], default="max")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--verbose", "-v", action="store_true")
    args = ap.parse_args(argv)

    if args.selftest:
        from tpu_deflate_torch.selftest import run_selftest

        return 0 if run_selftest(verbose=True, device=args.device) else 1

    if not args.file:
        ap.error("FILE required (or --selftest)")

    from tpu_deflate_torch import api

    cfg = _config(args.level)
    if args.file == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(args.file, "rb") as f:
            data = f.read()
    t0 = time.perf_counter()
    if args.decompress:
        out = api.decompress(data, cfg, device=args.device)
        default_name = args.file.removesuffix(".zz").removesuffix(".gz")
    else:
        out = (api.compress_gzip if args.gzip else api.compress)(
            data, cfg, device=args.device)
        default_name = args.file + (".gz" if args.gzip else ".zz")
    dt = time.perf_counter() - t0

    dest = args.output or default_name
    if dest == "-":
        sys.stdout.buffer.write(out)
    else:
        with open(dest, "wb") as f:
            f.write(out)
    if args.verbose:
        mb = max(len(data), len(out)) / 1e6
        print(
            f"{len(data)} -> {len(out)} bytes "
            f"({len(out) / max(len(data), 1):.3f}) in {dt:.2f}s "
            f"({mb / dt:.1f} MB/s incl. kernel builds)",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
