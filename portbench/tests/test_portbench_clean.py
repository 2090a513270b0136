"""The robust BA cell (`rpc_ba1000_clean.robust`) on the CPU at a test
size: its reference's soft-L1 against scipy's, whole runs sound and with
the stage broken underneath (each fault planted here), and the control."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import faults
from portbench import readings
from portbench import run as runm
from portbench import spec as specm
from portbench.reference import ba_clean, ba_lm
from portbench.scenes import generate
from portbench.tests import tiny

CPU = torch.device("cpu")
CELL = "rpc_ba1000_clean.robust"


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tiny_clean"))
    tiny.tiny_spec(root)
    path = os.path.join(root, "portbench", "configs", "rpc_ba1000_clean.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(n_cam=16, n_pts=1500)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return specm.Spec(root)


def test_the_references_soft_l1_is_scipys():
    """solve_soft_l1's answer on a tiny problem with moved observations is
    an optimum of scipy.optimize.least_squares(loss="soft_l1"): scipy,
    started there, neither lowers the robust cost (beyond 1e-9 of it) nor
    moves the residuals (beyond 1e-5 px); and it lies well below the start's
    cost. (From the start, scipy stops at its xtol 0.04% above it.)"""
    from scipy.optimize import least_squares

    q = generate.ba_problem(4, 40, 4, 2e-5, 0.1, 1.0, 0, CPU)
    q["pts2d"][::13] += 15.0
    prob = ba_lm.Problem(q, torch.float64, CPU)
    rows, pts = ba_clean.solve_soft_l1(prob, f_scale=1.0)
    m = prob.n_cam

    def fun(x):
        rot = torch.as_tensor(x[:3 * m].reshape(m, 3) * 1e-5)
        p = torch.as_tensor(x[3 * m:].reshape(-1, 3)) + prob.pts0
        return prob.residuals(ba_lm._rows(prob, rot), p).reshape(-1).numpy()

    x = np.concatenate([(rows[:, :3] / 1e-5).reshape(-1).numpy(),
                        (pts - prob.pts0).reshape(-1).numpy()])
    r_ref = fun(x)
    cost = ba_clean.robust_cost(torch.as_tensor(r_ref), 1.0)
    fit = least_squares(fun, x, loss="soft_l1", f_scale=1.0, ftol=1e-15, xtol=1e-15,
                        gtol=1e-15, max_nfev=200)
    assert fit.cost == pytest.approx(cost, rel=1e-9)
    np.testing.assert_allclose(fit.fun, r_ref, rtol=0, atol=1e-5)
    start = prob.residuals(ba_lm._rows(prob, prob.params0[:, :3]), prob.pts0)
    assert cost < 0.6 * ba_clean.robust_cost(start, 1.0)


def _removes_nothing(monkeypatch):
    """The outlier pass returns its input: no observation removed."""
    from sat_bundleadjust_tpu_torch.ba import outliers

    monkeypatch.setattr(outliers, "rm_outliers", lambda err, p, **kwargs: p)


def _l2_left_at_its_start(monkeypatch):
    """The L2 round's answer left at its start (the soft-L1 round sound)."""
    from sat_bundleadjust_tpu_torch.ba.solver import BASolver

    real = BASolver.solve

    def solve(self, ls_params=None, *args, **kwargs):
        out = real(self, ls_params, *args, **kwargs)
        return out if ls_params else (out[0], out[0]) + out[2:]

    monkeypatch.setattr(BASolver, "solve", solve)


def _soft_l1_left_at_its_start(monkeypatch):
    """The soft-L1 round's answer and errors left at its start (the outlier
    pass and the L2 round sound)."""
    from sat_bundleadjust_tpu_torch.ba.solver import BASolver

    real = BASolver.solve

    def solve(self, ls_params=None, *args, **kwargs):
        out = real(self, ls_params, *args, **kwargs)
        return (out[0], out[0], out[2], out[2], out[4]) if ls_params else out

    monkeypatch.setattr(BASolver, "solve", solve)


def _removes_inliers(monkeypatch):
    """The outlier pass's thresholds a fifth of the rule's: it removes
    inliers too."""
    from sat_bundleadjust_tpu_torch.ba import outliers

    real = outliers.camera_thresholds
    monkeypatch.setattr(outliers, "camera_thresholds", lambda *a, **kw: real(*a, **kw) / 5)


@pytest.mark.parametrize("fault", [None, _removes_nothing, _l2_left_at_its_start,
                                   _soft_l1_left_at_its_start, _removes_inliers,
                                   faults.half_of_the_cameras, faults.camera_answer_altered],
                         ids=lambda f: getattr(f, "__name__", "sound").strip("_"))
def test_the_robust_cell_is_correct_exactly_when_its_stage_is_sound(monkeypatch, spec, fault):
    tiny.on_the_cpu(monkeypatch)
    if fault is not None:
        fault(monkeypatch)
    result = runm.run(CELL, 2 ** 31 + 7, 0.1, 0, spec=spec, device=CPU)
    assert result["attempted"] >= 2
    assert result["correct"] == (fault is None), result["checks"]
    assert set(result["metrics"]) == {"setup_s", "ba_stage_s"}
    if fault is _removes_nothing:
        assert result["checks"]["moved_kept"]["value"] > 100
    if fault is _removes_inliers:
        assert result["checks"]["removed_diff"]["value"] > 100
    if fault is _soft_l1_left_at_its_start:
        assert result["checks"]["soft_excess"]["value"] > 1.0


def test_the_robust_cells_control_fails_where_the_program_passes(monkeypatch, spec):
    tiny.on_the_cpu(monkeypatch)
    limits = spec.cell(CELL)["limits"]
    (row,) = readings.readings(CELL, [17], CPU, spec=spec)
    for p in row["program"]:
        assert all(p[k] <= lim["max"] for k, lim in limits.items()), row
        assert p["moved_kept"] == 0 and p["removed_diff"] == 0
    for c in row["control"]:
        assert not all(c[k] <= lim["max"] for k, lim in limits.items()), row


def test_the_robust_cells_span_metrics_by_hand():
    """The three readers over a hand-made traced run."""
    from sat_bundleadjust_tpu_torch.utils import profiling

    spans = [(1, None, "ba.outliers", 100, 400, {}),
             (2, None, "ba.solve", 500, 1500, {"loss": "soft_l1"}),
             (3, None, "ba.solve", 1600, 1900, {"loss": "linear"}),
             (4, None, "ba.outliers", 2000, 2200, {})]
    run = {"units": [{"traced": True}, {"traced": True}, {"traced": False}],
           "trace": {"device_ops": [("k", 200, 300), ("k", 2000, 2100)], "window_s": 1e-6,
                     "busy_s": 2e-7}}
    real = profiling.spans
    profiling.spans = lambda: spans
    try:
        s = specm.Spec()
        assert s.reader("ba.outliers_s")(run) == pytest.approx(500e-9 / 2)
        assert s.reader("ba.outliers.idle_share")(run) == pytest.approx(100 * 300 / 500)
        assert s.reader("lm.soft_l1_s")(run) == pytest.approx(1000e-9 / 2)
    finally:
        profiling.spans = real
    assert s.reader("lm.soft_l1_s")({"units": [], "trace": None}) is None
