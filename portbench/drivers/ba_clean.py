"""Driver `ba_clean`: whole robust BA stages of the program's pipeline, one
after another.

A stage is what `pipeline.BundleAdjustmentPipeline` runs between its
tracks and its writes with `clean_outliers` true (the CLI's default), in
its order: the parameters (`BAParams.from_obs_table`), a solver
(`BASolver`), the soft-L1 round (`solver.SOFT_L1_ROUND`), the outlier pass
(`ba.outliers.rm_outliers`: thresholds, removal, track filters,
re-triangulation, the new parameters), a new solver on what was kept, the
L2 round and `reconstruct_vars`. The problem is `scenes/orbit.ba_problem`'s
(camera centres on the RPCs' lines of sight), with a share of its
observations moved by a few pixels and `pairs_to_triangulate` by the
upstream baseline rule. Every stage of the window runs the same problem
(moved from a fixed seed), its table in an order drawn from the run's seed,
which the program sorts. After the window one more stage runs a problem of
the seed's own (its noise and its moved observations drawn from the seed).

Each stage is judged from what it produced, by the reference
(portbench/reference/ba_clean.py): `soft_excess`, the robust cost of the
soft-L1 round's answer over the reference's soft-L1 optimum, less 1;
`removed_diff`, the observations on which the stage's outlier pass and the
reference's rule decide differently, the rule given the soft-L1 round's
own errors; `moved_kept`, the moved observations the stage kept;
`cost_excess` and `cam_gap_px` of the L2 answer against the reference's L2
optimum over the observations the stage kept (the reference's own copies
of them).
"""

import hashlib
import time

import numpy as np
import torch

from portbench.reference import ba_clean, ba_lm
from portbench.scenes import generate, orbit
from portbench.scenes import rpc as rpcm


def move_observations(problem, share, px, seed):
    """The problem with `share` of its observations moved by px[0]-px[1]
    pixels in a random direction, and their keys (point x cameras +
    camera), as chip_smoke.seed_outliers moves them."""
    rng = np.random.RandomState(seed)
    k = rng.choice(len(problem["pts2d"]), int(share * len(problem["pts2d"])), replace=False)
    ang = rng.uniform(0, 2 * np.pi, len(k))
    mag = rng.uniform(px[0], px[1], len(k))
    pts2d = np.array(problem["pts2d"])
    pts2d[k] += np.stack([np.cos(ang), np.sin(ang)], axis=1) * mag[:, None]
    keys = problem["pts_ind"][k].astype(np.int64) * len(problem["rpcs"]) + problem["cam_ind"][k]
    return dict(problem, pts2d=pts2d, moved=np.sort(keys))


def camera_rows(cams):
    """The corrected camera rows (M, 9) of reconstruct_vars' cameras."""
    return np.concatenate([np.asarray(x, np.float64).reshape(1, 9) for x in cams])


class CleanStages:
    def __init__(self, config, seed, device):
        from sat_bundleadjust_tpu_torch.ba import outliers
        from sat_bundleadjust_tpu_torch.ba.params import BAParams
        from sat_bundleadjust_tpu_torch.ba.solver import SOFT_L1_ROUND, BASolver
        from sat_bundleadjust_tpu_torch.models.rpc import RPCModel

        self.BAParams, self.BASolver, self.rm_outliers = BAParams, BASolver, outliers.rm_outliers
        self.soft_l1 = SOFT_L1_ROUND
        c = self.config = config
        self.make_problem = lambda noise_seed, moved_seed: move_observations(
            orbit.ba_problem(c["n_cam"], c["n_pts"], c["obs_per_pt"], c["rot_scale"],
                             c["noise_px"], c["noise_pts_m"], c["scene_seed"], device,
                             c["view_stride"], c["orbit_alt_m"], noise_seed=noise_seed),
            c["moved_share"], c["moved_px"], moved_seed)
        self.seed = seed
        self.problems = {"window": generate.shuffle(self.make_problem(None, c["moved_seed"]),
                                                    seed)}
        q = self.problems["window"]
        self.cameras = [RPCModel(**{k: np.asarray(r[k], np.float64) for k in rpcm.FIELDS})
                        for r in q["rpcs"]]
        self.pairs = orbit.triangulation_pairs(q["centers"], c["orbit_alt_m"], c["min_baseline"])
        self.device = device
        self.sizes = {"cameras": c["n_cam"], "tracks": c["n_pts"],
                      "observations": len(q["cam_ind"]), "moved": len(q["moved"]),
                      "pairs": len(self.pairs)}
        self._cache = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def params(self, q):
        return self.BAParams.from_obs_table(q["pts_ind"], q["cam_ind"], q["pts2d"], q["pts0"],
                                            self.cameras, "rpc", list(q["centers"]), self.pairs,
                                            {"verbose": False})

    def __call__(self, i, name="window"):
        q, c = self.problems[name], self.config
        t = [time.perf_counter()]
        p = self.params(q)
        t.append(time.perf_counter())
        solver = self.BASolver(p, device=self.device)
        self._sync()
        t.append(time.perf_counter())
        _, (cam1, pts1), _, err, soft = solver.solve(self.soft_l1)
        self._sync()
        t.append(time.perf_counter())
        p2 = self.rm_outliers(err, p, min_thr=c["min_thr"],
                              reference_rounding=c["reference_rounding"], device=self.device)
        self._sync()
        t.append(time.perf_counter())
        solver2 = self.BASolver(p2, device=self.device)
        self._sync()
        t.append(time.perf_counter())
        _, (cam, pts), _, _, l2 = solver2.solve(None)
        self._sync()
        t.append(time.perf_counter())
        pts_c, cams_c = p2.reconstruct_vars(cam, pts, p.pts3d, p.cameras)
        self._sync()
        t.append(time.perf_counter())
        phases = dict(zip(("params_s", "solver_s", "soft_l1_s", "outliers_s", "solver2_s",
                           "l2_s", "reconstruct_s"), np.diff(t)))
        kept = np.asarray(p2.pts_prev_indices, np.int64)[p2.pts_ind] * p.n_cam + p2.cam_ind
        return {"wall_s": t[-1] - t[0], "phases": phases, "rounds": [soft, l2], "problem": name,
                "removed": p.n_obs - p2.n_obs, "tracks_kept": p2.n_pts,
                "shapes": [{"M": s.n_cam, "N": s.n_pts, "K": s.n_obs, "P": s.n_params}
                           for s in (p, p2)],
                "kept": kept, "answer": (camera_rows(cams_c), pts_c),
                "soft": {"params": p, "answer": (cam1, pts1), "errors": err}}

    def after_window(self):
        """One stage on the seed's own problem, after the window."""
        moved_seed = generate.substreams(self.seed, 3)[2]
        self.problems["seed"] = self.make_problem(self.seed, moved_seed)
        return [self(-1, "seed")]

    # the reference's side, each solved once per problem (and kept table)

    def keys(self, name, rows):
        """The keys (point x cameras + camera) of problem `name`'s rows."""
        q = self.problems[name]
        return q["pts_ind"][rows].astype(np.int64) * len(q["rpcs"]) + q["cam_ind"][rows]

    def rows_of(self, name, keys):
        """The rows of problem `name`'s table that hold the observations
        `keys` (point x cameras + camera); raises on a key it lacks."""
        tag = ("order", name)
        if tag not in self._cache:
            own = self.keys(name, slice(None))
            order = np.argsort(own, kind="stable")
            self._cache[tag] = order, own[order]
        order, own = self._cache[tag]
        at = np.searchsorted(own, keys)
        if np.any(at >= len(own)) or np.any(own[np.minimum(at, len(own) - 1)] != keys):
            raise ValueError("the kept table holds observations that the problem lacks")
        return order[at]

    def l2_optimum(self, name, keys, dtype=torch.float64):
        """The kept problem in dtype, its tracks, and the reference's L2
        optimum on it."""
        tag = ("l2", name, hashlib.sha1(np.ascontiguousarray(keys).tobytes()).hexdigest(), dtype)
        if tag not in self._cache:
            sub, tracks = ba_clean.kept_problem(self.problems[name], self.rows_of(name, keys))
            prob = ba_lm.Problem(sub, dtype, self.device)
            self._cache[tag] = prob, tracks, ba_lm.solve(prob)
        return self._cache[tag]

    def soft_optimum(self, name, dtype=torch.float64):
        """The whole problem in dtype, the reference's soft-L1 optimum and
        its robust cost (float64)."""
        tag = ("soft", name, dtype)
        if tag not in self._cache:
            prob = ba_lm.Problem(self.problems[name], dtype, self.device)
            optimum = ba_clean.solve_soft_l1(prob, f_scale=self.soft_l1["f_scale"])
            self._cache[tag] = prob, optimum, self.soft_cost(name, optimum)
        return self._cache[tag]

    def soft_cost(self, name, answer):
        """The robust (soft-L1) cost of an answer (camera rows, points) on
        the whole problem, in float64."""
        tag = ("prob", name)
        if tag not in self._cache:
            self._cache[tag] = ba_lm.Problem(self.problems[name], torch.float64, self.device)
        prob = self._cache[tag]
        rows, pts = (torch.as_tensor(a).to(self.device, torch.float64) for a in answer)
        return ba_clean.robust_cost(prob.residuals(rows, pts), self.soft_l1["f_scale"])

    def reference_kept(self, name, err):
        """The rows the reference's rule keeps, given errors in the
        problem's row order (a bool mask)."""
        q = self.problems[name]
        dev = self.device
        return ba_clean.kept_rows(err, torch.as_tensor(q["cam_ind"], device=dev),
                                  torch.as_tensor(q["pts_ind"], device=dev), len(q["rpcs"]),
                                  len(q["pts0"]), self.pairs, self.config["min_thr"]).cpu().numpy()

    def judge(self, name, soft, err, keys, answer):
        """The numbers of one stage: its soft-L1 answer (camera rows,
        points), the errors its outlier pass was given (float64 tensor in
        the problem's row order), the observations it kept (keys) and its L2
        answer (camera rows, points)."""
        q = self.problems[name]
        kept = np.zeros(len(q["cam_ind"]), bool)
        kept[self.rows_of(name, keys)] = True
        *_, optimum_cost = self.soft_optimum(name)
        prob, tracks, optimum = self.l2_optimum(name, keys)
        rows, pts = answer
        numbers = ba_lm.compare(prob, (rows, np.asarray(pts)[tracks]), optimum)
        numbers.update(soft_excess=self.soft_cost(name, soft) / optimum_cost - 1.0,
                       removed_diff=int(np.sum(self.reference_kept(name, err) != kept)),
                       moved_kept=int(np.isin(q["moved"], keys).sum()))
        return numbers

    def judge_stage(self, rec):
        """judge() of one stage's record: its soft-L1 answer and errors
        taken from the stage's own parameters and solve."""
        name, p, soft = rec["problem"], rec["soft"]["params"], rec["soft"]
        pts_s, cams_s = p.reconstruct_vars(*soft["answer"], p.pts3d, p.cameras)
        err = torch.empty(p.n_obs, dtype=torch.float64, device=self.device)
        at = self.rows_of(name, np.asarray(p.pts_prev_indices, np.int64)[p.pts_ind] * p.n_cam
                          + p.cam_ind)
        err[torch.as_tensor(at, device=self.device)] = torch.as_tensor(soft["errors"]).to(
            self.device, torch.float64)
        return self.judge(name, (camera_rows(cams_s), pts_s), err, rec["kept"], rec["answer"])


make = CleanStages


def describe(records):
    """The phase walls and counts of the window's stages, for the run's
    earlier lines."""
    out = {k: [float(rec["phases"][k]) for rec in records] for k in records[0]["phases"]}
    for i, loss in enumerate(("soft_l1", "l2")):
        for k in ("iterations", "cg_iterations", "cg_masked", "capture_s"):
            out["{}.{}".format(loss, k)] = [rec["rounds"][i][k] for rec in records]
    out.update(removed=[rec["removed"] for rec in records],
               tracks_kept=[rec["tracks_kept"] for rec in records])
    return out


def check(stages, records):
    """Each stage's soft-L1 answer, outlier pass and L2 answer against the
    reference (float64)."""
    return [stages.judge_stage(r) for r in records]


def control(stages, records):
    """The control: the reference in float32 in the program's place (its
    soft-L1 optimum, its rule on that optimum's errors, its L2 optimum on
    what its rule kept), judged as a stage, once for each problem of the
    records."""
    answers = {}
    for name in {r["problem"] for r in records}:
        q = stages.problems[name]
        prob, soft, _ = stages.soft_optimum(name, torch.float32)
        err = ba_clean.errors(prob, soft)
        kept = stages.reference_kept(name, err)
        keys = np.sort(stages.keys(name, kept))
        sub, tracks = ba_clean.kept_problem(q, stages.rows_of(name, keys))
        rows, pts = ba_lm.solve(ba_lm.Problem(sub, torch.float32, stages.device))
        full = np.array(q["pts0"])
        full[tracks] = pts.cpu().numpy()
        answers[name] = stages.judge(name, tuple(a.cpu().numpy() for a in soft),
                                     err.to(torch.float64), keys, (rows.cpu().numpy(), full))
    return [answers[r["problem"]] for r in records]
