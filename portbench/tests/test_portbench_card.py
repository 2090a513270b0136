"""On the card: one run of each cell at the test sizes through the whole
harness, the look for a card included. Marked `cuda`; skips without one."""

import pytest

from portbench import run as runm
from portbench.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["rpc_ba1000.stage", "rpc_date10.cli"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_on_the_card(card, tmp_path, workload, trace):
    spec = tiny.tiny_spec(str(tmp_path))
    result = runm.run(workload, 2 ** 31 + 5, 1.0, trace, spec=spec)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]
