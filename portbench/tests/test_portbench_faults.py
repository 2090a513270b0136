"""The check decides `correct`: runs of both cells at the test sizes on the
CPU (the look for a card skipped), sound, and with the timed path broken
underneath in each way the cell can break (portbench/faults.py), must come
out correct and not correct. The cells run on one card, so no exchange
between cards can be left out. The control (tests below) is the
comparison's other end."""

import functools
import json

import pytest
import torch

from portbench import faults
from portbench import readings
from portbench import run as runm
from portbench.tests import tiny

CPU = torch.device("cpu")
# the tiny scene has 1 493 keypoints a view; the card's cell is capped at 8 192 of ~11 000
LOWER_KP_MAX = functools.partial(faults.lower_kp_max, cap=1000)


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return tiny.tiny_spec(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("workload,fault", [
    ("rpc_ba1000.stage", None),
    ("rpc_ba1000.stage", faults.unchanged),
    ("rpc_ba1000.stage", faults.half_of_the_observations),
    ("rpc_ba1000.stage", faults.camera_answer_altered),
    ("rpc_date10.cli", None),
    ("rpc_date10.cli", faults.unchanged),
    ("rpc_date10.cli", faults.half_of_the_cameras),
    ("rpc_date10.cli", faults.keypoints_altered),
    ("rpc_date10.cli", faults.half_of_the_pairs_unmatched),
    ("rpc_date10.cli", LOWER_KP_MAX),
], ids=lambda x: getattr(x, "__name__", getattr(getattr(x, "func", None), "__name__", x)))
def test_a_run_is_correct_exactly_when_its_path_is_sound(monkeypatch, spec, workload, fault):
    tiny.on_the_cpu(monkeypatch)
    if fault is not None:
        fault(monkeypatch)
    result = runm.run(workload, 2 ** 31 + 3, 0.1, 0, spec=spec, device=CPU)
    assert result["attempted"] >= 1
    assert result["correct"] == (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
    json.dumps(result)


def _passes(number, limit):
    return number <= limit["max"] if "max" in limit else number >= limit["min"]


@pytest.mark.parametrize("workload", ["rpc_ba1000.stage", "rpc_date10.cli"])
def test_the_control_fails_where_the_program_passes(monkeypatch, spec, workload):
    tiny.on_the_cpu(monkeypatch)
    limits = spec.cell(workload)["limits"]
    (row,) = readings.readings(workload, [17], CPU, spec=spec)
    assert all(_passes(p[k], lim) for p in row["program"] for k, lim in limits.items()), row
    for c in row["control"]:
        assert not all(_passes(c[k], lim) for k, lim in limits.items()), row
