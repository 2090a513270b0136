"""Distributed Schur-complement bundle adjustment over the ranks of a mesh.

Counterpart of `sat_bundleadjust_tpu/parallel/dist_solver.py`:

  * tie-point TRACKS are partitioned over the ranks (each track's
    observations live on one shard), so the 3x3 point blocks V and the
    point back-substitution are the shard's own;
  * the reduced camera system (g_cam, the right-hand side, and per CG
    iteration the Schur operator's result) is summed with one all-reduce
    where the JAX package takes its psum (ops/lm.py's `reduce`);
  * camera parameters and increments are replicated: every rank holds them
    whole and computes the same values from the same summed inputs;
  * the damped LM loop runs on every rank. Its decisions (accept, stop,
    the CG's stop) read only values that came out of a collective or were
    computed from such values alone, so the ranks take the same branches by
    construction and no rank waits in a collective that another skipped.

On the card each rank's CG operator is the schur_wz kernel
(ops/schur_matvec.SchurOperator), bound once per LM step on the shard's own
track-major and camera-major layouts.
"""

import time
import types

import numpy as np
import torch
import torch.distributed as dist

from sat_bundleadjust_tpu_torch.ops import lm as lm_ops
from sat_bundleadjust_tpu_torch.ops.robust import loss_cost
from sat_bundleadjust_tpu_torch.parallel.mesh import global_put, global_put_rows, make_mesh


def shard_observations(pts_ind, cam_ind, pts2d, weights, n_pts, n_shards, n_cam=None,
                       owned_shards=None):
    """Partition observations by track into n_shards balanced shards.

    owned_shards: optional list of shard indices to BUILD: the plan
    (track->shard assignment, pad sizes, table widths) is computed globally
    and deterministically on every rank, but the padded per-shard operand
    arrays are materialized only for the given shards (leading dim
    len(owned_shards), rows in its order). None = all shards.

    Returns dict of stacked padded arrays; padded entries have weight 0
    (they contribute exactly zero to residuals and normal equations, since r
    and J carry the weight factor). "obs_index" (n_shards, K_pad) maps each
    slot back to the original observation row (-1 for padding).

    Tracks are renumbered shard-locally ("pts_loc", L = max tracks per
    shard): "track_global" (L,) maps local->global (sentinel n_pts),
    "local_of_global" (n_pts,) maps global->local (sentinel L), so that the
    point step rejoins the replicated (n_pts, 3) state with one gather and
    one all-reduce. "cam_ind_pt"/"pts_ind_cam" are the per-shard dual padded
    layouts of ops/lm.LMProblem (absent when a dominant camera would blow
    their padding past 4x the shard's observation count). The arrays equal
    the JAX package's, key for key."""
    pts_ind = np.asarray(pts_ind)
    cam_ind = np.asarray(cam_ind)
    pts2d = np.asarray(pts2d)
    weights = np.asarray(weights)

    # group observation indices by track
    order = np.argsort(pts_ind, kind="stable")
    track_sizes = np.bincount(pts_ind, minlength=n_pts) if len(pts_ind) else np.zeros(n_pts, np.int64)

    # balanced assignment: tracks sorted by size descending, dealt in
    # serpentine order (0..S-1, S-1..0, ...)
    nz = np.where(track_sizes > 0)[0]
    by_size = nz[np.argsort(-track_sizes[nz], kind="stable")]
    pos = np.arange(len(by_size))
    fwd = pos % (2 * n_shards)
    serp = np.where(fwd < n_shards, fwd, 2 * n_shards - 1 - fwd)
    shard_of_track = np.zeros(n_pts, dtype=np.int64)
    shard_of_track[by_size] = serp

    # shard-major observation layout: obs ordered by (shard, global track,
    # original position)
    obs_track = pts_ind[order] if len(pts_ind) else np.zeros(0, np.int64)
    reorder = np.argsort(shard_of_track[obs_track], kind="stable") if len(obs_track) else np.zeros(0, np.int64)
    obs_global = order[reorder]  # original obs index, shard-major
    obs_shard = shard_of_track[pts_ind[obs_global]] if len(obs_global) else np.zeros(0, np.int64)
    counts_shard = np.bincount(obs_shard, minlength=n_shards)
    K_pad = max(int(counts_shard.max()) if len(obs_global) else 1, 1)
    starts = np.concatenate([[0], np.cumsum(counts_shard)])[:-1]
    slot = np.arange(len(obs_global)) - starts[obs_shard]

    owned = (np.arange(n_shards) if owned_shards is None
             else np.asarray(owned_shards, np.int64))
    n_owned = len(owned)
    pos_of_shard = np.full(n_shards, -1, np.int64)
    pos_of_shard[owned] = np.arange(n_owned)
    obs_owned = pos_of_shard[obs_shard] >= 0 if len(obs_global) else np.zeros(0, bool)

    def pad(arr, fill, dtype):
        out = np.full((n_owned, K_pad) + arr.shape[1:], fill, dtype=dtype)
        out[pos_of_shard[obs_shard[obs_owned]], slot[obs_owned]] = arr[obs_global[obs_owned]]
        return out

    # shard-local track renumbering: owned tracks in ascending global id
    if n_cam is None:
        n_cam = int(cam_ind.max()) + 1 if len(cam_ind) else 1
    track_order = nz[np.argsort(shard_of_track[nz], kind="stable")]
    track_shard = shard_of_track[track_order]
    counts_owned = np.bincount(track_shard, minlength=n_shards)
    L = max(int(counts_owned.max()) if len(nz) else 0, 1)
    starts_owned = np.concatenate([[0], np.cumsum(counts_owned)])[:-1]
    local_idx = (np.arange(len(track_order)) - starts_owned[track_shard]).astype(np.int32)
    tsel = pos_of_shard[track_shard] >= 0
    track_global = np.full((n_owned, L), n_pts, np.int32)
    local_of_global = np.full((n_owned, n_pts), L, np.int32)
    track_global[pos_of_shard[track_shard[tsel]], local_idx[tsel]] = track_order[tsel]
    local_of_global[pos_of_shard[track_shard[tsel]], track_order[tsel]] = local_idx[tsel]

    pts_loc = np.zeros((n_owned, K_pad), np.int32)
    if len(obs_global):
        rows = pos_of_shard[obs_shard[obs_owned]]
        pts_loc[rows, slot[obs_owned]] = local_of_global[
            rows, pts_ind[obs_global[obs_owned]]]

    # per-shard segment-sum tables over LOCAL padded obs positions (sentinel
    # K_pad: the zero row _seg_sum appends), built from real observations;
    # the widths are GLOBAL maxima, so every rank's rows have one shape
    T_pt = max(int(track_sizes.max()) if len(pts_ind) else 1, 1)
    T_cam = max(
        int(np.bincount(obs_shard * n_cam + cam_ind[obs_global]).max())
        if len(obs_global) else 1, 1)
    dual_ok = bool(
        np.all((counts_shard == 0)
               | ((L * T_pt <= 4 * counts_shard)
                  & (n_cam * T_cam <= 4 * counts_shard))))
    pt_gather = np.full((n_owned, L, T_pt), K_pad, np.int32)
    cam_gather = np.full((n_owned, n_cam, T_cam), K_pad, np.int32)
    for s in owned:
        n_s = int(counts_shard[s])
        r = pos_of_shard[s]
        loc = pts_loc[r, :n_s]
        tp = lm_ops.build_gather_segments(loc, L)
        tc = lm_ops.build_gather_segments(cam_ind[obs_global[starts[s]: starts[s] + n_s]], n_cam)
        tp[tp == n_s] = K_pad
        tc[tc == n_s] = K_pad
        pt_gather[r, :, : tp.shape[1]] = tp
        cam_gather[r, :, : tc.shape[1]] = tc

    # full-plan obs->original-row map, kept by every rank (the per-obs
    # errors are all-gathered before the scatter-back)
    obs_index = np.full((n_shards, K_pad), -1, np.int64)
    if len(obs_global):
        obs_index[obs_shard, slot] = obs_global

    out = {
        "pts_ind": pad(pts_ind, 0, np.int32),
        "cam_ind": pad(cam_ind, 0, np.int32),
        "pts2d": pad(pts2d, 0.0, np.float64),
        "weights": pad(weights, 0.0, np.float64),
        "pt_gather": pt_gather,
        "cam_gather": cam_gather,
        "pts_loc": pts_loc,
        "track_global": track_global,
        "local_of_global": local_of_global,
        "shard_of_track": shard_of_track,
        "obs_index": obs_index,
        "owned_shards": owned,
        "n_shards": n_shards,
    }
    if dual_ok:
        # dual padded layouts, indices local to the shard: camera of each
        # track-major slot (sentinel n_cam) and LOCAL point of each
        # camera-major slot (sentinel L)
        cam_pad = out["cam_ind"]
        tp, tc = out["pt_gather"], out["cam_gather"]

        def batched_gather_values(tables, values, fill):
            flat = np.minimum(tables, K_pad - 1).reshape(n_owned, -1)
            vals = np.take_along_axis(values, flat, axis=1).reshape(tables.shape)
            return np.where(tables < K_pad, vals, fill).astype(np.int32)

        out["cam_ind_pt"] = batched_gather_values(tp, cam_pad, n_cam)
        out["pts_ind_cam"] = batched_gather_values(tc, pts_loc, L)
    return out


# host-side metadata, not device operands
_HOST_KEYS = ("shard_of_track", "obs_index", "owned_shards", "n_shards")


class DistributedLM:
    """LM solve of a BAParams problem with its observations sharded over the
    ranks of a mesh: this rank holds its own shard (sharded, from
    shard_observations with owned_shards holding this rank's position) and
    the replicated state. cfg: the LMConfig (solved with the CG).

    time_collectives: synchronize the device around every collective and
    add its wall time to the counters (stats "collective_s"); off by
    default, since the synchronization costs the overlap of host and
    device."""

    def __init__(self, p, sharded, cfg, mesh=None, time_collectives=False):
        from sat_bundleadjust_tpu_torch.ba.solver import make_fns

        self.mesh = mesh if mesh is not None else make_mesh()
        self.cfg = cfg._replace(schur_mode=lm_ops.schur_solve(
            self.mesh.device, p.n_cam, cfg.schur_mode, cfg.tie_tail, distributed=True))
        if not self.cfg.cg_iters:  # the adaptive budget of ops/lm.build_solve
            self.cfg = self.cfg._replace(cg_iters=lm_ops.default_cg_iters(p.n_cam))
        self.p = p
        self.n_cam, self.n_pts = p.n_cam, p.n_pts
        self.time_collectives = time_collectives
        self.obs_index = np.asarray(sharded["obs_index"])
        self.n_obs = int((self.obs_index >= 0).sum())
        self.n_shards = int(sharded.get("n_shards", self.mesh.size))
        if self.n_shards != self.mesh.size:
            raise ValueError("DistributedLM: {} shards planned for a mesh of {} ranks".format(
                self.n_shards, self.mesh.size))
        owned = np.asarray(sharded.get("owned_shards", np.arange(self.n_shards)))
        dev = self.mesh.device
        rows = {k: global_put_rows(v, owned, self.n_shards, self.mesh)
                for k, v in sharded.items() if k not in _HOST_KEYS}
        long_keys = ("pts_ind", "cam_ind", "pts_loc", "pt_gather", "cam_gather",
                     "track_global", "local_of_global")
        self.obs = {k: v.long() if k in long_keys else v for k, v in rows.items()}
        self.cam_opt_mask = global_put(np.asarray(p.cam_opt_mask, np.float64), self.mesh)
        self.pts_opt_mask = global_put(np.asarray(p.pts_opt_mask, np.float64), self.mesh)
        self.n_loc = int(self.obs["track_global"].shape[0])
        # the shard's residuals and Jacobians: the one-device closures over
        # the shard's rows (global track ids), on this rank's device
        shard = types.SimpleNamespace(
            cam_model=p.cam_model, n_params=p.n_params, cam_params=p.cam_params, rpcs=p.rpcs,
            pts_ind=rows["pts_ind"].cpu().numpy(), cam_ind=rows["cam_ind"].cpu().numpy(),
            pts2d=rows["pts2d"].cpu().numpy(), pts2d_w=rows["weights"].cpu().numpy())
        self.local_residuals, self.local_jacobians = make_fns(shard, dev)
        self.prob = self.local_prob()
        self.stats = None
        self.last_info = None

    def local_prob(self):
        """The shard's LMProblem: its point side renumbered to the shard's
        own tracks (pts_loc / track_global), so V, V^-1, the operator's
        point reduce and the back-substitution are (L, ...) local arrays."""
        obs = self.obs
        tg = obs["track_global"]  # (L,) global id, sentinel n_pts
        n = self.pts_opt_mask.shape[0]
        pmask_loc = torch.where(tg < n, self.pts_opt_mask[torch.clamp(tg, max=n - 1)],
                                torch.ones_like(self.pts_opt_mask[:1]))
        return lm_ops.LMProblem(
            pts_ind=obs["pts_loc"], cam_ind=obs["cam_ind"], pts2d=obs["pts2d"],
            weights=obs["weights"], cam_opt_mask=self.cam_opt_mask, pts_opt_mask=pmask_loc,
            pt_gather=obs["pt_gather"], cam_gather=obs["cam_gather"],
            cam_ind_pt=obs.get("cam_ind_pt"), pts_ind_cam=obs.get("pts_ind_cam"),
        )

    def _reduce(self, t):
        """Sum t over the mesh's ranks, in place (the JAX package's psum);
        the identity where no process group was initialized (one rank)."""
        if not dist.is_initialized():
            return t
        t = t.contiguous()
        if self.stats is None:  # outside a solve (cost): nothing to count
            dist.all_reduce(t, group=self.mesh.group)
            return t
        self.stats["allreduces"] += 1
        if self.time_collectives and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self.mesh.group)
        if self.time_collectives and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        self.stats["collective_s"] += time.perf_counter() - t0
        return t

    def _cost(self, cam, pts, loss, f_scale):
        r = self.local_residuals(cam, pts)
        return self._reduce(loss_cost(loss, r, f_scale).reshape(1))[0], r

    def cost(self, cam, pts):
        """The loss of (cam, pts) under the configuration's loss and f_scale,
        summed over the ranks (one all-reduce): a float, the same on every
        rank. Called on every rank, outside solve."""
        c, _ = self._cost(self._put(cam), self._put(pts), self.cfg.loss, self.cfg.f_scale)
        return float(c)

    def _put(self, x):
        return torch.as_tensor(x, dtype=torch.float64, device=self.mesh.device)

    def _gather_errs(self, errs):
        """The (2, K_pad) before/after errors of every shard, all-gathered,
        scattered back to original observation order -> (2, n_obs)."""
        if dist.is_initialized() and self.mesh.size > 1:
            parts = [torch.empty_like(errs) for _ in range(self.mesh.size)]
            dist.all_gather(parts, errs.contiguous(), group=self.mesh.group)
            err = torch.stack(parts).cpu().numpy()
        else:
            err = errs[None].cpu().numpy()
        out = np.zeros((2, self.n_obs), np.float32)
        mask = self.obs_index >= 0
        for i in range(2):
            out[i, self.obs_index[mask]] = err[:, i, :][mask]
        return out

    def solve(self, cam0, pts0, cfg=None):
        """Full LM solve from (cam0, pts0), on every rank. Returns (cam, pts,
        info); info carries cost0/cost, iterations, lambda, the per-
        observation reprojection errors before/after in original observation
        order, and the counters (host syncs, CG iterations, matvecs,
        all-reduces, collective_s, wall_time).

        cfg: optional per-round LMConfig (its max_iter, loss and f_scale)."""
        from sat_bundleadjust_tpu_torch.parallel import multihost

        rc = cfg or self.cfg
        cfg = self.cfg._replace(loss=rc.loss, f_scale=rc.f_scale, max_iter=rc.max_iter)
        loss, f_scale = cfg.loss, cfg.f_scale
        t_start = time.time()
        # ranks can arrive here far apart (per-rank pipeline stages)
        multihost.barrier("dist_solve")
        self.stats = stats = _new_stats()
        cam, pts = self._put(cam0), self._put(pts0)
        local_of_global = self.obs["local_of_global"]

        cost0, r0 = self._cost(cam, pts, loss, f_scale)
        cost_floor = torch.clamp(1e-15 * torch.clamp(cost0, min=1.0), min=1e-14 * self.n_obs)
        lam = torch.tensor(cfg.lambda0, dtype=cam.dtype, device=cam.device)
        cost = cost0
        done = torch.zeros((), dtype=torch.bool, device=cam.device)
        dcam_prev = torch.zeros_like(cam)
        n_iter = 0
        while n_iter < cfg.max_iter:
            if n_iter > 0:
                stats["host_syncs"] += 1
                if bool(done):  # from summed costs and replicated steps only
                    break
            r, J_cam, J_pt = self.local_jacobians(cam, pts)
            dcam, dpt_loc = lm_ops.lm_step(
                r, J_cam, J_pt, lam, self.prob, self.n_cam, self.n_loc, cfg, loss=loss,
                f_scale=f_scale, x0_cam=dcam_prev, stats=stats, reduce=self._reduce)
            # rejoin the replicated point state: each global track's step
            # from its shard (zero elsewhere, the appended sentinel row),
            # then one all-reduce
            dpt_pad = torch.cat([dpt_loc, torch.zeros((1, 3), dtype=dpt_loc.dtype,
                                                      device=dpt_loc.device)])
            dpt = self._reduce(dpt_pad[local_of_global])
            cam_new = cam + dcam
            pts_new = pts + dpt
            new_cost, _ = self._cost(cam_new, pts_new, loss, f_scale)
            improved = new_cost < cost
            rel_drop = (cost - new_cost) / torch.clamp(cost, min=1e-30)
            step_norm = torch.sqrt(torch.sum(dcam * dcam) + torch.sum(dpt * dpt))
            x_norm = torch.sqrt(torch.sum(cam * cam) + torch.sum(pts * pts))
            small_step = step_norm < cfg.xtol * (x_norm + cfg.xtol)
            cam = torch.where(improved, cam_new, cam)
            pts = torch.where(improved, pts_new, pts)
            lam = torch.where(improved, lam / cfg.lambda_down, lam * cfg.lambda_up)
            cost = torch.where(improved, new_cost, cost)
            done = (
                done
                | (improved & (rel_drop < cfg.ftol))
                | (improved & small_step)
                | (lam > 1e12)
                | (cost <= cost_floor)
            )
            # the camera step warm-starts the next CG (replicated, like cam)
            dcam_prev = dcam.to(cam.dtype)
            n_iter += 1

        # per-observation unweighted reprojection errors of the shard
        w = self.obs["weights"]
        valid = w > 0
        safe_w = torch.where(valid, w, torch.ones_like(w))[:, None]
        r_fin = self.local_residuals(cam, pts)
        zero = torch.zeros_like(w)
        errs = torch.stack([torch.where(valid, torch.linalg.norm(r0 / safe_w, dim=1), zero),
                            torch.where(valid, torch.linalg.norm(r_fin / safe_w, dim=1), zero)])
        errs = self._gather_errs(errs.to(torch.float32))
        scalars = torch.stack([lam, cost, cost0]).cpu().numpy()
        info = {
            "cost0": float(scalars[2]),
            "cost": float(scalars[1]),
            "iterations": n_iter,
            "lambda": float(scalars[0]),
            "err0": errs[0],
            "err_fin": errs[1],
        }
        info.update(stats)
        self.stats = None
        info["wall_time"] = time.time() - t_start
        self.last_info = {k: v for k, v in info.items() if k not in ("err0", "err_fin")}
        return cam, pts, info


def _new_stats():
    stats = lm_ops.new_stats()
    stats.update(allreduces=0, collective_s=0.0)
    return stats


def run_ba_optimization_distributed(p, ls_params=None, verbose=False, mesh=None, solver=None):
    """Distributed drop-in for ba.solver.run_ba_optimization: the same
    signature and return contract ((vars_init, vars_ba, err_init, err_ba,
    iterations)), with the per-observation errors in original observation
    order."""
    t0 = time.time()
    (cam0, pts0), (cam, pts), info = run_distributed_ba(p, ls_params, mesh=mesh, solver=solver)
    err_init, err_ba = info["err0"], info["err_fin"]
    if verbose:
        print("LM solve (distributed, {} shards): cost {:.6g} -> {:.6g} in {} iterations, "
              "{:.2f}s".format(info["n_shards"], info["cost0"], info["cost"],
                               info["iterations"], time.time() - t0))
        print("Reprojection error before BA (mean / median): {:.2f} / {:.2f}".format(
            float(np.mean(err_init)), float(np.median(err_init))))
        print("Reprojection error after  BA (mean / median): {:.2f} / {:.2f}".format(
            float(np.mean(err_ba)), float(np.median(err_ba))))
    return (cam0, pts0), (cam, pts), np.asarray(err_init), np.asarray(err_ba), info["iterations"]


def make_distributed_solver(p, ls_params=None, mesh=None, time_collectives=False):
    """Shard a BAParams problem over the mesh and build this rank's
    DistributedLM (only this rank's shard rows are built). The solver
    serves every round of one problem structure (soft-L1, outlier probe,
    L2)."""
    from sat_bundleadjust_tpu_torch.ba.solver import init_optimization_config, tie_tail
    from sat_bundleadjust_tpu_torch.parallel.multihost import local_shard_ids

    ls = init_optimization_config(ls_params)
    cfg = lm_ops.LMConfig(
        loss=ls["loss"], f_scale=float(ls["f_scale"]), max_iter=int(ls["max_iter"]),
        ftol=float(ls["ftol"]), xtol=float(ls["xtol"]),
        cg_coarse_k=lm_ops.default_coarse_k(p.n_cam), tie_tail=tie_tail(p),
    )
    mesh = mesh if mesh is not None else make_mesh()
    sharded = shard_observations(p.pts_ind, p.cam_ind, p.pts2d, p.pts2d_w, p.n_pts, mesh.size,
                                 owned_shards=local_shard_ids(mesh))
    return DistributedLM(p, sharded, cfg, mesh=mesh, time_collectives=time_collectives)


def run_distributed_ba(p, ls_params=None, mesh=None, solver=None):
    """Distributed counterpart of ba.solver.run_ba_optimization for a
    BAParams problem: shard its observation table over the mesh and solve.
    Pass a prebuilt `solver` (make_distributed_solver) to reuse its shard
    across rounds. Returns ((cam0, pts0), (cam, pts), info), info with
    n_shards."""
    from sat_bundleadjust_tpu_torch.ba.solver import init_optimization_config

    if solver is None:
        solver = make_distributed_solver(p, ls_params, mesh=mesh)
    ls = init_optimization_config(ls_params)
    round_cfg = solver.cfg._replace(
        loss=ls["loss"], f_scale=float(ls["f_scale"]), max_iter=int(ls["max_iter"]))
    cam0 = solver._put(p.opt_block())
    pts0 = solver._put(p.pts3d)
    cam, pts, info = solver.solve(cam0, pts0, cfg=round_cfg)
    info["n_shards"] = solver.mesh.size
    return (cam0, pts0), (cam, pts), info
