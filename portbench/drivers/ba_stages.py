"""Driver `ba_stages`: whole BA stages of the program's pipeline, one after
another.

A stage is what `pipeline.BundleAdjustmentPipeline` runs between its
tracks and its writes with `clean_outliers` false: the parameters
(`ba.params.BAParams`), a new solver (`ba.solver.BASolver`, its tables and
its CUDA graphs), its L2 round (`solve(None)`, the solver's defaults) and
`reconstruct_vars`. Every stage of the window runs the same problem, its
observation table in an order drawn from the seed, which the program sorts:
the seed does not change the window's work, since any change of the
problem's numbers moves where the solver stops, and with it the work.
After the window one more stage runs a problem of the seed's own (its
observation noise drawn from the seed), so that each run's check also
judges a problem that no other seed has.
"""

import time

import numpy as np
import torch

from portbench.reference import ba_lm
from portbench.scenes import generate
from portbench.scenes import rpc as rpcm


class Stages:
    def __init__(self, config, seed, device):
        from sat_bundleadjust_tpu_torch.ba.params import BAParams
        from sat_bundleadjust_tpu_torch.ba.solver import BASolver
        from sat_bundleadjust_tpu_torch.models.rpc import RPCModel

        self.BAParams, self.BASolver = BAParams, BASolver
        c = config
        self.make_problem = lambda noise_seed=None: generate.ba_problem(
            c["n_cam"], c["n_pts"], c["obs_per_pt"], c["rot_scale"], c["noise_px"],
            c["noise_pts_m"], c["scene_seed"], device, noise_seed=noise_seed)
        self.seed = seed
        self.problems = {"window": generate.shuffle(self.make_problem(), seed)}
        q = self.problems["window"]
        self.cameras = [RPCModel(**{k: np.asarray(r[k], np.float64) for k in rpcm.FIELDS})
                        for r in q["rpcs"]]
        n = c["n_cam"]
        self.pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        self.device = device
        self.sizes = {"cameras": n, "tracks": c["n_pts"],
                      "observations": len(q["cam_ind"])}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, i, name="window"):
        q = self.problems[name]
        t = [time.perf_counter()]
        p = self.BAParams.from_obs_table(q["pts_ind"], q["cam_ind"], q["pts2d"], q["pts0"],
                                         self.cameras, "rpc", list(q["centers"]), self.pairs,
                                         {"verbose": False})
        t.append(time.perf_counter())
        solver = self.BASolver(p, device=self.device)
        self._sync()
        t.append(time.perf_counter())
        _, (cam, pts), _, _, info = solver.solve(None)
        self._sync()
        t.append(time.perf_counter())
        pts_c, cams_c = p.reconstruct_vars(cam, pts, p.pts3d, p.cameras)
        self._sync()
        t.append(time.perf_counter())
        phases = dict(zip(("params_s", "solver_s", "solve_s", "reconstruct_s"), np.diff(t)))
        return {"wall_s": t[-1] - t[0], "phases": phases, "rounds": [info], "problem": name,
                "shapes": [{"M": p.n_cam, "N": p.n_pts, "K": p.n_obs, "P": p.n_params}],
                "answer": (np.concatenate([np.asarray(x).reshape(1, 9) for x in cams_c]), pts_c)}

    def after_window(self):
        """One stage on the seed's own problem, after the window."""
        self.problems["seed"] = self.make_problem(noise_seed=self.seed)
        return [self(-1, "seed")]

    def reference(self, name):
        """The float64 problem `name` and the reference's optimum on it
        (solved once)."""
        if not hasattr(self, "_optimum"):
            self._optimum = {}
        if name not in self._optimum:
            prob = ba_lm.Problem(self.problems[name], torch.float64, self.device)
            self._optimum[name] = prob, ba_lm.solve(prob)
        return self._optimum[name]


make = Stages


def describe(records):
    """The phase walls and counts of the window's stages, for the run's
    earlier lines."""
    rounds = [r for rec in records for r in rec["rounds"]]
    out = {k: [float(rec["phases"][k]) for rec in records] for k in records[0]["phases"]}
    out.update({k: [r[k] for r in rounds] for k in ("iterations", "cg_iterations", "cg_masked",
                                                    "matvecs", "capture_s")})
    return out


def check(stages, records):
    """Each stage's answer against the reference's optimum on its problem
    (float64)."""
    return [ba_lm.compare(*_judged(stages, r["problem"], r["answer"])) for r in records]


def control(stages, records):
    """The control: the reference solved in float32 in the program's place,
    judged as an answer, once for each problem of the records."""
    answers = {}
    for name in {r["problem"] for r in records}:
        f32 = ba_lm.Problem(stages.problems[name], torch.float32, stages.device)
        answers[name] = ba_lm.compare(*_judged(stages, name, ba_lm.solve(f32)))
    return [answers[r["problem"]] for r in records]


def _judged(stages, name, answer):
    prob, optimum = stages.reference(name)
    return prob, answer, optimum
