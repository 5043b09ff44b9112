"""The byte counts at the shapes of PERF.md's kernel table: 128 lanes of
64 KiB of the corpus's first 8 MiB, window 256, max_match 10, static trees
(``PIN_STATIC``, 4869675 B, so 4869669 B of lanes), and the same lanes at
``FULL_WINDOW`` (``PIN_FULL_WINDOW``, 2002794 B, so 2002788 B of lanes).

The matcher's count reproduces the table's "Bound ms" column (0.02254).
The bit-pack's counts what the job needs, 8 bytes an emission read and
the lanes' bytes written, and so lies under the table's 0.05261, which
counts the kernel's own buffers (entries of 4 + 4 * channels bytes, and
channel sums over the output capacity)."""

import pytest

from portbench import rooflines
from portbench.manifest import HERE
from portbench.trace import hand_kernels

HBM = 3.35e12
LANES, CHUNK = 128, 65536


def shape(dynamic: bool, window: int, max_match: int, stream_bytes: int) -> dict:
    return {"lanes": LANES, "chunk": CHUNK, "raw_bytes": LANES * CHUNK, "window": window,
            "max_match": max_match, "dynamic_encode": dynamic,
            "lane_bytes": [stream_bytes - 6] + [0] * (LANES - 1)}


STATIC = shape(False, 256, 10, 4869675)
FULL_WINDOW = shape(True, 32768, 258, 2002794)
PACK = ["mono_scatter_add_lead_kernel", "mono_scatter_add_kernel"]


@pytest.mark.parametrize("kernels, call, nbytes, bound_ms", [
    # 9 bytes a position and 4 a lane: the kernel table's 0.02254
    (["match2_kernel"], STATIC, LANES * CHUNK * 9 + 4 * LANES, 0.02254),
    # (65536 + 2) emissions a lane of 8 bytes, then the lanes' bytes
    (PACK, STATIC, LANES * 65538 * 8 + 4869669, 0.02149),
    # (1 + 340 + 2 * 65536 + 1) emissions a lane of 8 bytes, then the lanes' bytes
    (PACK, FULL_WINDOW, LANES * 131414 * 8 + 2002788, 0.04077),
])
def test_counts_at_the_tables_shapes(kernels, call, nbytes, bound_ms):
    total = sum(rooflines.least_bytes(k, call) for k in kernels)
    assert total == nbytes
    assert round(total / HBM * 1e3, 5) == bound_ms


def test_the_bitpack_count_lies_under_the_tables_bound():
    assert sum(rooflines.least_bytes(k, STATIC) for k in PACK) / HBM * 1e3 < 0.05261


def test_a_short_last_lane_counts_its_own_positions():
    call = {**STATIC, "raw_bytes": 3 * CHUNK + 100, "lanes": 4, "lane_bytes": [10, 20, 30, 40]}
    assert rooflines.least_bytes("mono_scatter_add_kernel", call) == (
        8 * (3 * (CHUNK + 2) + 102) + 100)


def test_every_kernel_of_the_cells_has_a_count():
    from portbench.program import Port

    launched = {"match2_kernel", "mono_scatter_add_lead_kernel", "mono_scatter_add_kernel"}
    assert launched <= hand_kernels(Port("cpu").csrc())
    for k in launched:
        assert (HERE / "rooflines" / f"{k}.py").is_file()


def test_share_counts_time_without_a_file_and_needs_a_peak():
    class Call:
        shape = STATIC

        def kernel_us(self, hand):
            return {"match2_kernel": 100.0, "no_file_kernel": 100.0}

    peak = {"hbm_bytes_per_s": HBM}
    share = rooflines.share([Call()], set(), peak)
    assert share == pytest.approx(100 * 0.02254e-3 / 200e-6, rel=1e-3)
    assert rooflines.share([Call()], set(), None) is None
