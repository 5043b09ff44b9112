"""Round-trip self-test on the device: a built-in corpus through device
encode -> host reference decode, device decode of the device's stream and
of a stream from the host reference encoder (so the test needs no zlib),
and exact compressed sizes, which any change to the parse or the
emissions alters.  The pinned sizes are the JAX package's.

    python -m tpu_deflate_torch.selftest   # on the card
"""

from __future__ import annotations

from tpu_deflate_torch.config import LOWLUT, DeflateConfig


def _bench_corpus(size: int = 2200) -> bytes:
    """Numbered lines of text, cut to ``size`` bytes."""
    out = bytearray()
    i = 0
    while len(out) < size:
        out.extend(b"Hello world line %d!\n" % i)
        i += 1
    return bytes(out[:size])


def run_selftest(config: DeflateConfig | None = None, verbose: bool = True,
                 device="cuda") -> bool:
    """The self-test on ``device``; True when every check passes."""
    from tpu_deflate_torch import api
    from tpu_deflate_torch.ref.deflate import zlib_compress
    from tpu_deflate_torch.ref.inflate import zlib_decompress

    cfg = config or DeflateConfig(window=256, max_match=10, chunk_size=4096)
    data = _bench_corpus()
    ok = True

    def report(name, passed, extra=""):
        nonlocal ok
        ok = ok and passed
        if verbose:
            print(f"  [{'PASS' if passed else 'FAIL'}] {name} {extra}")

    # 1. device compress -> host reference decode
    comp = api.compress(data, cfg, device=device)
    report("device-encode/host-decode", zlib_decompress(comp) == data,
           f"({len(data)} -> {len(comp)} bytes)")

    # 2. the compressed output back through the device decoder
    report("device round-trip", api.decompress(comp, cfg, device=device) == data)

    # 3. a stream of the host reference encoder, decoded on the device
    golden = zlib_compress(data, cfg)
    report("device-decode of golden stream",
           api.decompress(golden, cfg, device=device) == data)

    # 4. exact compressed sizes: static (window 256, max_match 10), dynamic
    #    (the full window, max_match 258, lazy) and FAST (window 32)
    if config is None:
        report("exact compressed size (static, win256/m10/4K)",
               len(comp) == 0x234, f"({len(comp):#x} == 0x234)")
        dyn_cfg = DeflateConfig(window=32768, max_match=258, chunk_size=4096,
                                lazy=True, dynamic_encode=True)
        dyn_comp = api.compress(data, dyn_cfg, device=device)
        report("exact compressed size (dynamic, win32K/m258/lazy)",
               len(dyn_comp) == 0xFF, f"({len(dyn_comp):#x} == 0xff)")
        report("dynamic stream round-trips", zlib_decompress(dyn_comp) == data)
        fast_cfg = DeflateConfig(fast=True, window=32, chunk_size=4096)
        fast_comp = api.compress(data, fast_cfg, device=device)
        report("exact compressed size (FAST, win32)",
               len(fast_comp) == 0x21B, f"({len(fast_comp):#x} == 0x21b)")
        report("FAST stream round-trips", zlib_decompress(fast_comp) == data)
        # LOWLUT: decompress-only, static trees, one block — a one-block
        # static stream of the host encoder
        golden_1blk = zlib_compress(data, DeflateConfig(
            window=256, max_match=10, chunk_size=1 << 20, one_block=True))
        report("host golden one-block stream size pinned (precondition)",
               len(golden_1blk) == 0x234, f"({len(golden_1blk):#x} == 0x234)")
        report("LOWLUT decode of one-block static stream",
               api.decompress(golden_1blk, LOWLUT, device=device) == data)
    else:
        # a caller's config: the loose size bound
        report("compressed-size bound", len(comp) <= len(data) // 3,
               f"({len(comp)} <= {len(data) // 3})")

    if verbose:
        print("SELFTEST", "PASSED" if ok else "FAILED")
    return ok


if __name__ == "__main__":
    import sys

    sys.exit(0 if run_selftest() else 1)
