"""The LM solve as blocks of masked CG iterations (ops/lm.py), on the CPU.

On the card each LM iteration runs as CUDA graphs (build_solve); the same
phases run eagerly here. They must give, bit for bit, what a loop of single
CG iterations with a host read before each one gives: that loop and the LM
loop around it are kept below as they were (`_per_iteration_cg`,
`_per_iteration_solve`). A small rpc scene solved through BASolver is also
held to the JAX package's solve under tests/test_torch_solver.py's
tolerance.
"""

import numpy as np
import pytest
import torch

from test_torch_common import both_problems, jax_scene

from sat_bundleadjust_tpu.ba import solver as jsolver

from sat_bundleadjust_tpu_torch.ba import solver as tsolver
from sat_bundleadjust_tpu_torch.ba.params import BAParams
from sat_bundleadjust_tpu_torch.ops import lm as tlm
from sat_bundleadjust_tpu_torch.ops.robust import loss_cost
from sat_bundleadjust_tpu_torch.utils import demo

CG_ITERS = 10  # a multiple of none of the blocks below


def _per_iteration_cg(cg, stats):
    """The CG loop of single iterations: the stop read before each one."""
    x, r, p, rz, one = cg.x, cg.r, cg.p, cg.rz, cg.one
    it = 0
    while it < cg.cg_iters:
        stats["host_syncs"] += 1
        if not bool(torch.sum(r * r) > cg.tol):
            break
        Ap = cg.proj(cg.matvec(p))
        denom = torch.sum(p * Ap)
        alpha = rz / torch.where(denom.abs() < 1e-30, one, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = cg.apply_prec(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(rz.abs() < 1e-30, one, rz)
        p = z + beta * p
        rz = rz_new
        it += 1
    stats["cg_iterations"] += it
    stats["cg_steps"].append(it)
    return x.to(cg.out_dtype)


def _per_iteration_solve(solver, cfg, stats):
    """The LM loop with the stop read before each iteration after the first
    and the CG of _per_iteration_cg. Returns (cam, pts, iterations)."""
    prob, p = solver.prob, solver.p
    cam = torch.as_tensor(p.opt_block(), dtype=torch.float64)
    pts = torch.as_tensor(p.pts3d, dtype=torch.float64)
    cost0 = loss_cost(cfg.loss, solver.residual_fn(cam, pts), cfg.f_scale)
    cost_floor = torch.clamp(1e-15 * torch.clamp(cost0, min=1.0), min=1e-14 * p.n_obs)
    lam = torch.tensor(cfg.lambda0, dtype=cam.dtype)
    cost = cost0
    done = torch.zeros((), dtype=torch.bool)
    dcam_prev = torch.zeros_like(cam)
    n_iter = 0
    while n_iter < cfg.max_iter:
        if n_iter > 0:
            stats["host_syncs"] += 1
            if bool(done):
                break
        r, J_cam, J_pt = solver.jac_fn(cam, pts)
        system = tlm._schur_system(r, J_cam, J_pt, lam, prob, p.n_cam, p.n_pts, cfg,
                                   loss=cfg.loss, f_scale=cfg.f_scale)
        solve = tlm._solve_of(prob, p.n_cam, cfg)
        if solve != tlm.CG:
            dcam = tlm._dense_solve(system, prob, p.n_cam, solve)
        else:
            dcam = _per_iteration_cg(tlm._cg_of(system, prob, p.n_cam, cfg, dcam_prev, stats),
                                     stats)
        dcam, dpt = tlm._back_substitute(dcam, system, prob, p.n_pts)
        cam_new = cam + dcam
        pts_new = pts + dpt
        new_cost = loss_cost(cfg.loss, solver.residual_fn(cam_new, pts_new), cfg.f_scale)
        improved = new_cost < cost
        rel_drop = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        step_norm = torch.sqrt(torch.sum(dcam * dcam) + torch.sum(dpt * dpt))
        x_norm = torch.sqrt(torch.sum(cam * cam) + torch.sum(pts * pts))
        small_step = step_norm < cfg.xtol * (x_norm + cfg.xtol)
        cam = torch.where(improved, cam_new, cam)
        pts = torch.where(improved, pts_new, pts)
        lam = torch.where(improved, lam / cfg.lambda_down, lam * cfg.lambda_up)
        cost = torch.where(improved, new_cost, cost)
        done = (done | (improved & (rel_drop < cfg.ftol)) | (improved & small_step)
                | (lam > 1e12) | (cost <= cost_floor))
        dcam_prev = dcam.to(cam.dtype)
        n_iter += 1
    return cam, pts, n_iter


def _rpc_solver(schur_mode="cg"):
    scene = demo.make_scene_arrays(n_cam=12, n_pts=800, seed=7, device="cpu")
    return tsolver.BASolver(demo.scene_to_baparams(scene), schur_mode=schur_mode, device="cpu")


def _common_k_solver():
    """Perspective cameras with R, T, K and COMMON_K (P = 11): the CG runs on
    the projected operator (tie_tail)."""
    s = demo.make_matrix_scene("perspective", n_cam=8, n_pts=300, obs_per_pt=4, n_views=8,
                               noise_px=0.05, seed=0)
    p = BAParams.from_obs_table(s["pts_ind"], s["cam_ind"], s["pts2d"], s["pts0"],
                                s["cameras_init"], "perspective", s["camera_centers"], [],
                                {"verbose": False,
                                 "correction_params": ["R", "T", "K", "COMMON_K"]})
    return tsolver.BASolver(p, device="cpu")


@pytest.fixture(scope="module")
def solvers():
    return {"rpc": _rpc_solver(), "common_k": _common_k_solver()}


def _system(solver, cfg, lam=1e-3):
    p = solver.p
    cam = torch.as_tensor(p.opt_block(), dtype=torch.float64)
    pts = torch.as_tensor(p.pts3d, dtype=torch.float64)
    r, J_cam, J_pt = solver.jac_fn(cam, pts)
    return tlm._schur_system(r, J_cam, J_pt, torch.tensor(lam, dtype=torch.float64),
                             solver.prob, p.n_cam, p.n_pts, cfg)


@pytest.mark.parametrize("problem", ["rpc", "common_k"])
@pytest.mark.parametrize("stop", ["tol", "budget"])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("coarse", [True, False])
@pytest.mark.parametrize("k,first", [(1, True), (1, False), (3, False), (8, False)])
def test_masked_cg_blocks_give_the_per_iteration_bits(solvers, problem, stop, warm, coarse, k,
                                                      first):
    """run_cg's blocks of k masked iterations against the loop of single
    iterations on the same set-up: the same x bit for bit, the same active
    iterations, one host read per block (and one before the first when
    read_first, as the distributed solve reads), one operator application
    per iteration run. The stop is the forcing term (cg_rtol 0.1) or the
    budget (cg_rtol 1e-6); the warm start is the solution of two iterations
    (enough, at times, to stop before the first iteration); COMMON_K
    projects."""
    solver = solvers[problem]
    M = solver.p.n_cam
    cfg = solver.config()._replace(cg_iters=CG_ITERS, cg_coarse=coarse,
                                   cg_rtol=0.1 if stop == "tol" else 1e-6)
    assert (cfg.tie_tail > 0) == (problem == "common_k")
    system = _system(solver, cfg)
    x0 = None
    if warm:
        x0 = _per_iteration_cg(tlm._cg_of(system, solver.prob, M, cfg._replace(cg_iters=2), None,
                                          tlm.new_stats()), tlm.new_stats())
    old = tlm.new_stats()
    want = _per_iteration_cg(tlm._cg_of(system, solver.prob, M, cfg, x0, old), old)
    new = tlm.new_stats()
    cg = tlm._cg_of(system, solver.prob, M, cfg, x0, new)
    n = tlm.run_cg(lambda: cg.iterations(k), cg.status, k, new, read_first=first)
    assert torch.equal(cg.solution(), want)
    # a good warm start can meet the forcing term with no iteration at all
    assert n == new["cg_iterations"] == old["cg_iterations"] and (n > 0 or warm)
    assert (n == CG_ITERS) == (stop == "budget")
    ran = n + new["cg_masked"]
    if first:
        assert new["host_syncs"] == n + 1 and ran == n
    else:
        assert new["host_syncs"] == max(1, -(-n // k)) and ran == new["host_syncs"] * k
    assert new["matvecs"] - old["matvecs"] == ran - n


@pytest.mark.parametrize("case", ["rpc", "rpc-block-3", "rpc-block-1", "rpc-no-coarse",
                                  "common_k", "dense"])
def test_masked_lm_gives_the_per_iteration_bits(solvers, monkeypatch, case):
    """build_solve (the phases the card captures, run eagerly) against the
    LM loop of single CG iterations: the same cameras and points bit for
    bit, the same LM iterations and CG iterations of each step. On the CPU
    a CG block is one iteration ("rpc-block-1"); the other cases give it
    the card's blocks of 8, or 3. Host reads: one per CG block, and the
    stop before each LM iteration after the first."""
    k = 3 if case == "rpc-block-3" else 1 if case == "rpc-block-1" else 8
    if k > 1:
        monkeypatch.setattr(tlm, "cg_block", lambda cg_iters, captured: max(1, min(k, cg_iters)))
    solver = _rpc_solver("dense") if case == "dense" else solvers[case.split("-")[0]]
    cfg = solver.config({"max_iter": 12, "loss": "soft_l1"})._replace(
        cg_iters=CG_ITERS, cg_coarse=case != "rpc-no-coarse")
    old = tlm.new_stats()
    cam, pts, iters = _per_iteration_solve(solver, cfg, old)
    run = tlm.build_solve(solver.residual_fn, solver.jac_fn, solver.p.n_cam, solver.p.n_pts,
                          solver.prob, cfg)
    cam0 = torch.as_tensor(solver.p.opt_block(), dtype=torch.float64)
    pts0 = torch.as_tensor(solver.p.pts3d, dtype=torch.float64)
    got_cam, got_pts, info = run(cam0, pts0, cfg.max_iter, cfg.loss, cfg.f_scale)
    assert torch.equal(got_cam, cam) and torch.equal(got_pts, pts)
    assert info["iterations"] == iters > 1
    assert info["cg_steps"] == old["cg_steps"] and info["cg_iterations"] == old["cg_iterations"]
    lm_reads = iters - 1 + int(iters < cfg.max_iter)
    if case == "dense":
        assert info["host_syncs"] == old["host_syncs"] == lm_reads
        assert info["matvecs"] == 0 and not info["cg_steps"]
        return
    blocks = [max(1, -(-n // k)) for n in info["cg_steps"]]
    assert info["host_syncs"] == sum(blocks) + lm_reads
    assert info["host_syncs"] <= sum(-(-n // k) + 1 for n in info["cg_steps"])
    assert info["cg_masked"] == sum(blocks) * k - info["cg_iterations"]
    # one application per iteration run, and one per pre phase (warm start)
    assert info["matvecs"] == sum(blocks) * k + iters
    assert info["graph_replays"] == 0 and info["capture_s"] == 0.0


def test_solver_solves_again_on_its_driver(solvers):
    """BASolver builds its LM driver once per configuration: a second solve
    reuses it and gives the same bits."""
    solver = solvers["rpc"]
    _, (cam1, pts1), _, e1, info1 = solver.solve({"max_iter": 6})
    _, (cam2, pts2), _, e2, info2 = solver.solve({"max_iter": 6})
    assert len(solver._drivers) == 1
    assert torch.equal(cam1, cam2) and torch.equal(pts1, pts2) and np.array_equal(e1, e2)
    assert info1["iterations"] == info2["iterations"] and info1["cg_steps"] == info2["cg_steps"]
    solver.solve({"max_iter": 6, "loss": "soft_l1"})
    assert len(solver._drivers) == 1


def test_small_rpc_scene_matches_jax_solve():
    """4 cameras and 300 tracks through BASolver's CG solve on both packages:
    the final mean reprojection error within 1e-3 px of JAX's and the LM
    iterations within 2 (tests/test_torch_solver.py's tolerance). On
    another scene (seed 4) the two stop 3 iterations apart, as they did
    before the solve ran in blocks: both trajectories agree to 3e-7 px
    through 6 iterations, where the port's relative cost drop falls just
    under ftol; there, solves cut at 5 iterations agree within 1e-5 px."""
    ls = {"max_iter": 50}
    jp, tp = both_problems(jax_scene(n_cam=4, n_pts=300, seed=0))
    _, _, je0, je1, jit = jsolver.run_ba_optimization(jp, ls, schur_mode="cg")
    _, _, te0, te1, tit = tsolver.run_ba_optimization(tp, ls, schur_mode="cg", device="cpu")
    np.testing.assert_allclose(te0, je0, rtol=1e-5, atol=1e-6)
    assert te1.mean() < 0.2 * te0.mean()
    assert abs(float(te1.mean()) - float(je1.mean())) <= 1e-3
    assert abs(tit - jit) <= 2
    jp, tp = both_problems(jax_scene(n_cam=4, n_pts=300, seed=4))
    *_, je1, _ = jsolver.run_ba_optimization(jp, {"max_iter": 5}, schur_mode="cg")
    *_, te1, _ = tsolver.run_ba_optimization(tp, {"max_iter": 5}, schur_mode="cg", device="cpu")
    assert abs(float(te1.mean()) - float(je1.mean())) <= 1e-5
