"""The dynamic trees' launch has a byte count, and at FULL_WINDOW's shape
(128 lanes of 64 KiB) it counts a start flag a position read and 10561
bytes a lane written."""

from portbench import rooflines
from portbench.manifest import HERE
from portbench.trace import hand_kernels

LANES, CHUNK = 128, 65536
CALL = {"lanes": LANES, "chunk": CHUNK, "raw_bytes": LANES * CHUNK, "window": 32768,
        "max_match": 258, "dynamic_encode": True, "lane_bytes": [0] * LANES}


def test_the_dyntrees_kernel_has_a_count():
    from portbench.program import Port

    assert "dyntrees_kernel" in hand_kernels(Port("cpu").csrc())
    assert (HERE / "rooflines" / "dyntrees_kernel.py").is_file()


def test_count_at_the_full_window_shape():
    assert rooflines.least_bytes("dyntrees_kernel", CALL) == LANES * CHUNK + 10561 * LANES
