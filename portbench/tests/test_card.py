"""Each cell at its own size on the card, for a few seconds: correct."""

import time

import pytest

from portbench import manifest


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in manifest.load_manifest()["workloads"]])
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from portbench.program import Port
    from portbench.run import run_cell

    r = run_cell(manifest.cell(workload), 2**31 + 99, 2.0, False, Port("cuda"), time.time())
    assert r["correct"], r["checks"]
