"""The exact far matcher's three launches have byte counts, and at
FULL_WINDOW's shape (128 lanes of 64 KiB) they count what each launch's
role reads and writes once."""

import pytest

from portbench import rooflines
from portbench.manifest import HERE
from portbench.trace import hand_kernels

LANES, CHUNK = 128, 65536
CALL = {"lanes": LANES, "chunk": CHUNK, "raw_bytes": LANES * CHUNK, "window": 32768,
        "max_match": 258, "dynamic_encode": True, "lane_bytes": [0] * LANES}
FARMATCH = ["farmatch_keys_kernel", "farmatch_prev_kernel", "farmatch_kernel"]


def test_every_farmatch_kernel_has_a_count():
    from portbench.program import Port

    assert set(FARMATCH) <= hand_kernels(Port("cpu").csrc())
    for k in FARMATCH:
        assert (HERE / "rooflines" / f"{k}.py").is_file()


@pytest.mark.parametrize("kernel, per_position, per_lane", [
    ("farmatch_keys_kernel", 1 + 12, 4),      # bytes in, three int32 keys out
    ("farmatch_prev_kernel", 3 * (4 + 8 + 4), 0),  # sorted key and order in, prev out
    ("farmatch_kernel", 1 + 4 + 4, 4),        # bytes in, distance and length out
])
def test_counts_at_the_full_window_shape(kernel, per_position, per_lane):
    assert rooflines.least_bytes(kernel, CALL) == LANES * CHUNK * per_position + per_lane * LANES
