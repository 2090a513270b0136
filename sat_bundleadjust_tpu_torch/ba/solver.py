"""Bundle adjustment solve driver.

Counterpart of `sat_bundleadjust_tpu/ba/solver.py`: residual and Jacobian
closures over the observation table of a BAParams problem, the LMProblem
structure, and the Levenberg-Marquardt engine of ops/lm.py. The
optimization keys mirror the reference's (loss, ftol, xtol, f_scale,
max_iter, verbose).

The rpc model has closed-form Jacobians (ops/jacobians.py) in the chosen
Jacobian dtype; the affine and perspective models take theirs by
forward-mode AD of the per-observation residual (torch.func.jacfwd under
vmap) in float64, as the JAX package does with jax.jacfwd.
"""

from typing import NamedTuple

import numpy as np
import torch

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.models.rpc import map_rpc
from sat_bundleadjust_tpu_torch.ops import lm as lm_ops
from sat_bundleadjust_tpu_torch.ops.fastgeo import anchors_from_rpcs
from sat_bundleadjust_tpu_torch.ops.jacobians import residuals_and_jacobians_rpc, residuals_rpc
from sat_bundleadjust_tpu_torch.ops.project import affine_from_params, perspective_from_params
from sat_bundleadjust_tpu_torch.utils.profiling import span


# the pipeline's soft-L1 round (clean_outliers): the ls_params of
# BundleAdjustmentPipeline.run_ba_softL1, before the outlier pass and its L2 round
SOFT_L1_ROUND = {"loss": "soft_l1", "f_scale": 1.0, "max_iter": 300}


def init_optimization_config(config=None):
    """Defaults identical to the reference's."""
    keys = ["loss", "ftol", "xtol", "f_scale", "max_iter", "verbose"]
    defaults = ["linear", 1e-4, 1e-10, 1.0, 300, 1]
    out = dict(zip(keys, defaults))
    if config:
        for k in keys:
            if k in config:
                out[k] = config[k]
    return out


def _obs_residual_fn(proj_of):
    """Residual of one observation of a matrix camera, w * (proj - obs),
    (2,): cam_opt the optimized prefix, cam_tail the constant rest."""

    def fn(cam_opt, pt, cam_tail, obs2d, w):
        return w * (proj_of(pt, torch.cat([cam_opt, cam_tail])) - obs2d)

    return fn


class Observations(NamedTuple):
    """The observation table of a BAParams on the solver's device, shared by
    the closures and the LMProblem. nbytes: what was copied to the device
    (0 on the CPU, where the tensors take the arrays as they are)."""

    pts_ind: torch.Tensor  # (K,) int64
    cam_ind: torch.Tensor  # (K,) int64
    pts2d: torch.Tensor  # (K, 2) f64
    weights: torch.Tensor  # (K,) f64
    nbytes: int


def upload_observations(p, device):
    """p's observation table on device, in one copy of each array; the
    indices go up in their own dtype and widen to int64 there."""
    dev = torch.device(device)
    host = (np.ascontiguousarray(p.pts_ind), np.ascontiguousarray(p.cam_ind),
            np.ascontiguousarray(p.pts2d, np.float64), np.ascontiguousarray(p.pts2d_w, np.float64))
    pts_ind, cam_ind, pts2d, w = (torch.as_tensor(a, device=dev) for a in host)
    nbytes = 0 if dev.type == "cpu" else sum(a.nbytes for a in host)
    return Observations(pts_ind.long(), cam_ind.long(), pts2d, w, nbytes)


def make_fns(p, device, jac_dtype=torch.float32, obs=None):
    """(residual_fn, jac_fn) over the observation table of a BAParams, on
    device: residual_fn(cam_opt, pts3d) -> r (K, 2) f64; jac_fn -> (r,
    J_cam, J_pt), the rpc Jacobians in jac_dtype, the matrix models' in
    float64. obs: the table already on device (upload_observations)."""
    dev = torch.device(device)
    n_params = p.n_params
    f64 = torch.float64
    cam_tail = torch.as_tensor(p.cam_params[:, n_params:], dtype=f64, device=dev)
    obs = upload_observations(p, dev) if obs is None else obs
    pts_ind, cam_ind, pts2d, w = obs.pts_ind, obs.cam_ind, obs.pts2d, obs.weights

    if p.cam_model != "rpc":
        proj_of = affine_from_params if p.cam_model == "affine" else perspective_from_params
        jac_obs = torch.func.vmap(torch.func.jacfwd(_obs_residual_fn(proj_of), argnums=(0, 1)))
        tail_k = cam_tail[cam_ind]

        def residual_fn(cam_opt, pts3d):
            camv = torch.cat([cam_opt[cam_ind], tail_k], dim=1)
            return w[:, None] * (proj_of(pts3d[pts_ind], camv) - pts2d)

        def jac_fn(cam_opt, pts3d):
            cam_k, pt_k = cam_opt[cam_ind], pts3d[pts_ind]
            J_cam, J_pt = jac_obs(cam_k, pt_k, tail_k, pts2d, w)
            return residual_fn(cam_opt, pts3d), J_cam, J_pt

        return residual_fn, jac_fn

    rpcs = map_rpc(lambda f: f.to(dev), p.rpcs)
    anchors = anchors_from_rpcs(rpcs)

    def residual_fn(cam_opt, pts3d):
        full_cam = torch.cat([cam_opt, cam_tail], dim=1)
        return residuals_rpc(pts3d, rpcs, full_cam, pts_ind, cam_ind, pts2d, w, anchors)

    def jac_fn(cam_opt, pts3d):
        full_cam = torch.cat([cam_opt, cam_tail], dim=1)
        return residuals_and_jacobians_rpc(
            pts3d, rpcs, full_cam, pts_ind, cam_ind, pts2d, w, n_params, anchors,
            jac_dtype=jac_dtype,
        )

    return residual_fn, jac_fn


def tie_tail(p):
    """The parameters COMMON_K ties across a BAParams' cameras (0: none)."""
    return p.n_params_k if getattr(p, "common_k", False) else 0


def build_problem(p, device, schur_mode=None, obs=None):
    """The LMProblem of a BAParams on device, and its Schur mode, "dense" or
    "cg": the solve ops/lm.schur_solve chooses for schur_mode (None: the
    default) on that device, with p's cameras and COMMON_K. Its index
    tables, those of that solve, are built there from the observation table
    (obs, else uploaded here) by ops/lm.problem_tables."""
    dev = torch.device(device)
    obs = upload_observations(p, dev) if obs is None else obs
    tables, solve = lm_ops.problem_tables(obs.pts_ind, obs.cam_ind, p.n_pts, p.n_cam,
                                          schur_mode, tie_tail(p))

    def f64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)

    prob = lm_ops.LMProblem(
        pts_ind=obs.pts_ind,
        cam_ind=obs.cam_ind,
        pts2d=obs.pts2d,
        weights=obs.weights,
        cam_opt_mask=f64(p.cam_opt_mask),
        pts_opt_mask=f64(p.pts_opt_mask),
        **tables,
    )
    return prob, "cg" if solve == lm_ops.CG else "dense"


class BASolver:
    """Solver for one BAParams problem structure on one device: builds the
    closures, the LMProblem and the LM driver (ops/lm.build_solve, whose
    CUDA graphs it keeps) once, for every round solved on it. `last_info`
    holds the counters of the last solve (iterations, host syncs, CG
    iterations, masked ones, matvecs, graph replays, capture and wall
    time)."""

    def __init__(self, p, schur_mode=None, jac_dtype=None, device=None):
        self.p = p
        self.device = resolve_device(device)
        with span("ba.solver.init", tables_on=self.device.type) as init:
            with span("ba.upload"):
                obs = upload_observations(p, self.device)
            init.attrs["h2d_bytes"] = obs.nbytes
            with span("ba.make_fns"):
                self.residual_fn, self.jac_fn = make_fns(
                    p, self.device, torch.float32 if jac_dtype is None else jac_dtype, obs)
            with span("ba.build_problem"):
                self.prob, self.mode = build_problem(p, self.device, schur_mode, obs)
        self._drivers = {}

    def driver(self, cfg, graphs=True):
        """build_solve's run for cfg, made once per configuration that the
        graphs depend on (loss, f_scale and max_iter are run's arguments)."""
        key = (cfg._replace(loss="linear", f_scale=1.0, max_iter=0), graphs)
        if key not in self._drivers:
            self._drivers[key] = lm_ops.build_solve(self.residual_fn, self.jac_fn, self.p.n_cam,
                                                    self.p.n_pts, self.prob, cfg, graphs=graphs)
        return self._drivers[key]

    def config(self, ls_params=None):
        """The LMConfig of a solve, in the solver's mode. COMMON_K ties the
        trailing n_params_k parameters across the optimized cameras."""
        ls = init_optimization_config(ls_params)
        return lm_ops.LMConfig(
            loss=ls["loss"],
            f_scale=float(ls["f_scale"]),
            max_iter=int(ls["max_iter"]),
            ftol=float(ls["ftol"]),
            xtol=float(ls["xtol"]),
            schur_mode=self.mode,
            tie_tail=tie_tail(self.p),
            cg_coarse_k=lm_ops.default_coarse_k(self.p.n_cam),
        )

    def solve(self, ls_params=None, verbose=False, graphs=True):
        """One LM solve from the problem's initial state. Returns
        ((cam0, pts0), (cam, pts), err_init, err_ba, info). graphs=False
        runs the card's solve eagerly, for checks of its graphs only."""
        cfg = self.config(ls_params)
        cam0 = torch.as_tensor(self.p.opt_block(), dtype=torch.float64, device=self.device)
        pts0 = torch.as_tensor(self.p.pts3d, dtype=torch.float64, device=self.device)
        with span("ba.solve", loss=cfg.loss) as wall:
            cam, pts, info = self.driver(cfg, graphs)(cam0, pts0, cfg.max_iter, cfg.loss,
                                                      cfg.f_scale)
        err_init = info.pop("err0")
        err_ba = info.pop("err_fin")
        info["wall_time"] = wall.seconds
        self.last_info = info
        return (cam0, pts0), (cam, pts), err_init, err_ba, info


def run_ba_optimization(p, ls_params=None, verbose=False, schur_mode=None, solver=None,
                        jac_dtype=None, device=None):
    """Solve the BA problem of a BAParams instance.

    Returns (vars_init, vars_ba, err_init, err_ba, iterations), vars_* being
    (cam_opt, pts3d) tensor tuples on the solver's device. Pass a BASolver
    via `solver` to reuse its tables across rounds."""
    if solver is None:
        solver = BASolver(p, schur_mode=schur_mode, jac_dtype=jac_dtype, device=device)
    (cam0, pts0), (cam, pts), err_init, err_ba, info = solver.solve(ls_params, verbose)
    if verbose:
        print("LM solve ({} mode): cost {:.6g} -> {:.6g} in {} iterations, {:.2f}s".format(
            solver.mode, info["cost0"], info["cost"], info["iterations"], info["wall_time"]))
        print("Reprojection error before BA (mean / median): {:.2f} / {:.2f}".format(
            float(np.mean(err_init)), float(np.median(err_init))))
        print("Reprojection error after  BA (mean / median): {:.2f} / {:.2f}".format(
            float(np.mean(err_ba)), float(np.median(err_ba))))
    return (cam0, pts0), (cam, pts), err_init, err_ba, info["iterations"]


def _reproj_err(residuals, weights):
    """Unweighted L2 reprojection error per observation (numpy)."""
    r = np.asarray(residuals) / np.asarray(weights)[:, None]
    return np.linalg.norm(r, axis=1)


def compute_mean_reprojection_error_per_track(err, pts_ind, n_pts):
    """Mean reprojection error per track, as a segment mean."""
    err = np.asarray(err)
    sums = np.bincount(pts_ind, weights=err, minlength=n_pts)
    counts = np.bincount(pts_ind, minlength=n_pts)
    return sums / np.maximum(counts, 1)
