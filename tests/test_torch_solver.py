"""Parity of the port's LM solver with the JAX package on the CPU: one LM
step (dense and CG) from the same residuals, Jacobians and damping, and
whole solves of a 16-camera demo scene."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_common import both_problems, jax_scene, t

from sat_bundleadjust_tpu.ba import solver as jsolver
from sat_bundleadjust_tpu.ops import lm as jlm

from sat_bundleadjust_tpu_torch.ba import solver as tsolver
from sat_bundleadjust_tpu_torch.ops import lm as tlm


@pytest.fixture(scope="module")
def step_inputs():
    """r, J_cam, J_pt (f32 Jacobians) at a perturbed start of a 12-camera
    problem, from the JAX package, and both packages' problems: the port's
    with the tables of each solve (the intra-track pairs from
    build_intra_track_pairs, since this table, whose pairs do not repeat,
    gets obs_at)."""
    jp, tp = both_problems(jax_scene(n_cam=12, n_pts=800, seed=7))
    js = jsolver.BASolver(jp, schur_mode="cg")
    r, J_cam, J_pt = js.jac_fn(jnp.asarray(jp.opt_block()), jnp.asarray(jp.pts3d))
    dense, mode = tsolver.build_problem(tp, "cpu", "dense")
    assert mode == "dense" and dense.obs_at is not None and dense.pair_k1 is None
    pairs = [t(a).long() for a in tlm.build_intra_track_pairs(tp.pts_ind, tp.n_pts)]
    tprobs = {"cg": tsolver.build_problem(tp, "cpu", "cg")[0], "dense": dense,
              "pairs": dense._replace(obs_at=None, pair_k1=pairs[0], pair_k2=pairs[1])}
    return dict(jprob=js.prob, tprobs=tprobs, M=jp.n_cam, N=jp.n_pts,
                r=np.asarray(r), J_cam=np.asarray(J_cam), J_pt=np.asarray(J_pt))


def _steps(s, jcfg, tcfg, lam, pair_path=False):
    jprob, tprob = s["jprob"], s["tprobs"]["pairs" if pair_path else tcfg.schur_mode]
    if pair_path:
        jprob = jprob._replace(obs_at=None)
    jd = jlm.lm_step(jnp.asarray(s["r"]), jnp.asarray(s["J_cam"]), jnp.asarray(s["J_pt"]),
                     jnp.asarray(lam), jprob, s["M"], s["N"], jcfg)
    stats = tlm.new_stats()
    td = tlm.lm_step(t(s["r"]), t(s["J_cam"]), t(s["J_pt"]), lam, tprob, s["M"], s["N"],
                     tcfg, stats=stats)
    return [np.asarray(a) for a in jd], [a.numpy() for a in td], stats


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("lam", [1e-3, 10.0])
@pytest.mark.parametrize("pair_path", [False, True])
@pytest.mark.parametrize("loss", ["linear", "soft_l1"])
def test_lm_step_dense_matches_jax(step_inputs, lam, pair_path, loss):
    """The f32 normal equations and an f32 Cholesky solve of the reduced
    camera system on both sides; they differ by the order of f32 sums
    (torch and XLA reduce in other orders), which the reduced system's
    conditioning amplifies. At lam = 1e-3 each side lies ~2e-4 (of the
    largest entry) from the f64 solution of the same system, and 2e-4
    from the other: 1e-3 of the largest step entry."""
    cfg = jlm.LMConfig(schur_mode="dense", loss=loss)
    tcfg = tlm.LMConfig(schur_mode="dense", loss=loss)
    (jc, jpt), (tc, tpt), _ = _steps(step_inputs, cfg, tcfg, lam, pair_path)
    assert tc.dtype == np.float32 and tc.shape == jc.shape and tpt.shape == jpt.shape
    assert _rel(tc, jc) <= 1e-3
    assert _rel(tpt, jpt) <= 1e-3


@pytest.mark.parametrize("lam", [1e-3, 10.0])
@pytest.mark.parametrize("matvec", [("twin_f64", "auto"), ("aos", "aos")])
def test_lm_step_cg_matches_jax(step_inputs, lam, matvec):
    """CG through the port's plain operator ("auto" on the CPU) against the
    JAX f64-accumulator twin, and the aos forms against each other. The CG
    runs up to 15 f32 iterations on the same f32 normal equations as the
    dense step, whose summation-order noise (~2e-4 of the largest entry at
    lam = 1e-3, see above) CG carries through: 1e-3 of the largest step
    entry."""
    jmv, tmv = matvec
    cfg = jlm.LMConfig(schur_mode="cg", matvec=jmv)
    tcfg = tlm.LMConfig(schur_mode="cg", matvec=tmv)
    (jc, jpt), (tc, tpt), stats = _steps(step_inputs, cfg, tcfg, lam)
    assert 0 < stats["cg_iterations"] <= tlm.default_cg_iters(step_inputs["M"])
    # one operator application per CG iteration, one host sync per loop test
    assert stats["matvecs"] == stats["cg_iterations"] and stats["cg_masked"] == 0
    assert stats["host_syncs"] in (stats["cg_iterations"], stats["cg_iterations"] + 1)
    assert _rel(tc, jc) <= 1e-3
    assert _rel(tpt, jpt) <= 1e-3


@pytest.mark.parametrize("mode", ["dense", "cg"])
def test_solve_matches_jax(mode):
    """run_ba_optimization on a 16-camera demo scene: the final mean
    reprojection error within 1e-3 px of JAX's, LM iterations within 2."""
    jp, tp = both_problems(jax_scene(n_cam=16, n_pts=1000, seed=0))
    ls = {"max_iter": 50}
    _, _, je0, je1, jit = jsolver.run_ba_optimization(jp, ls, schur_mode=mode)
    (cam0, _), (cam, pts), te0, te1, tit = tsolver.run_ba_optimization(
        tp, ls, schur_mode=mode, device="cpu")
    assert cam.dtype == torch.float64 and cam.device.type == "cpu"
    np.testing.assert_allclose(te0, je0, rtol=1e-5, atol=1e-6)
    assert te1.mean() < 0.2 * te0.mean()
    assert abs(float(te1.mean()) - float(je1.mean())) <= 1e-3
    assert abs(tit - jit) <= 2


def test_solve_stats_count_cg_work():
    """A CG solve reports its host syncs and operator applications, and on
    the CPU launches no kernel."""
    from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv

    _, tp = both_problems(jax_scene(n_cam=8, n_pts=300, seed=2))
    solver = tsolver.BASolver(tp, schur_mode="cg", device="cpu")
    before = smv.schur_wz.launches
    *_, info = solver.solve({"max_iter": 10})
    assert smv.schur_wz.launches == before
    assert info["matvecs"] >= info["cg_iterations"] > 0
    # one sync per CG loop test and one per LM loop test after the first
    assert info["host_syncs"] >= info["cg_iterations"] + info["iterations"] - 1
    assert info["cg_iterations"] == sum(info["cg_steps"])
    assert len(info["cg_steps"]) == info["iterations"]
    # on the CPU a CG block is one iteration, read after it (the first block
    # of a step runs, masked, even when the step needs no iteration)
    stopped = int(info["iterations"] < 10)
    assert info["host_syncs"] == (sum(max(1, n) for n in info["cg_steps"]) + info["iterations"]
                                  - 1 + stopped)
    assert info["cg_masked"] == sum(n == 0 for n in info["cg_steps"])
    # one application per CG iteration run and one for each warm start
    assert info["matvecs"] == info["cg_iterations"] + info["cg_masked"] + info["iterations"]
    assert info["graph_replays"] == 0 and info["capture_s"] == 0.0
