#!/usr/bin/env python3
"""The port's bundle-adjustment walls, one source tree against another, on
one GPU.

    python3 scripts/torch_ba_walls.py ab --base DIR [--out DIR]

`ab` builds the kernels of both trees (the repository's and the one at
`--base`, e.g. an earlier commit unpacked with `git archive`), renders
chip_smoke.py's scenes of slices D and E to disk once, then runs the same
work in four child processes, base, this tree, this tree, base, each with
the `sat_bundleadjust_tpu_torch` of its tree first on sys.path:

  - the BA solves of chip_smoke.py's slices A (soft-L1, outlier removal, L2,
    each on a new BASolver as the pipeline makes them), B (L2 at 1000
    cameras) and F (P = 11 at 1000 cameras, P = 8 at 50), each a first
    solve on its solver and then the same solve again on that solver;
  - the CLI's chain (`sat_bundleadjust_tpu_torch.main`) on slice D's frames
    and on slice E's in ba_sequential and ba_global, and with perspective
    cameras on slice E's first date (slice F's CLI).

Each solve's wall (synchronized), LM and CG iterations and host reads, and
each CLI's wall, BA stage walls (soft-L1, outliers, L2) and the wall of
every BA round it solved go to `<out>/<label>_<n>.json`; `compare` prints
the table of both trees and the share of solves in which this tree is the
slower. `--tiny` shrinks every size and runs on the CPU (a rehearsal of the
script; its walls mean nothing).
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 900


def _load_chip_smoke(tiny):
    """chip_smoke.py's scene constants and renderers (this tree's), shrunk
    with tiny."""
    if REPO not in sys.path:
        sys.path.append(REPO)
    import chip_smoke as cs

    if tiny:
        cs.SLICE_C.update(views=4, h=400, w=400, n_tex=512)
        cs.SLICE_E.update(h=400, w=400, n_tex=512)
        cs.SLICE_D_CONFIG["FT_kp_max"] = 3000
        cs.SLICE_E_CONFIG["FT_kp_max"] = 3000
    return cs


def render(scenes, tiny):
    """Slice D's frames (chip_smoke's slice C views with their biased RPCs,
    as slice_d writes them) into scenes/d, slice E's into scenes/e."""
    import numpy as np
    from PIL import Image

    cs = _load_chip_smoke(tiny)
    from sat_bundleadjust_tpu_torch.models.rpc import write_rpc_file

    dev = "cpu" if tiny else "cuda"
    d_dir, e_dir = os.path.join(scenes, "d"), os.path.join(scenes, "e")
    os.makedirs(d_dir, exist_ok=True)
    os.makedirs(e_dir, exist_ok=True)
    t0 = time.time()
    for k, im in enumerate(cs.render_scene_c(dev)):
        name = "20200413_1514{:02d}_view{}".format(10 + k, k)
        Image.fromarray(np.asarray(im.geotiff_path)).save(os.path.join(d_dir, name + ".tif"))
        write_rpc_file(im.rpc, os.path.join(d_dir, name + ".rpc"))
    cs.render_scene_e(dev, e_dir)
    print("rendered slices D and E in {:.1f} s".format(time.time() - t0), flush=True)


def _solve(solver, ls, tag, out):
    import numpy as np
    import torch

    sync = torch.cuda.synchronize if solver.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.time()
    _, _, _, e1, info = solver.solve(ls)
    sync()
    rec = {"tag": tag, "wall_s": time.time() - t0, "iterations": info["iterations"],
           "cg_iterations": info.get("cg_iterations"), "host_syncs": info.get("host_syncs"),
           "matvecs": info.get("matvecs"), "capture_s": info.get("capture_s"),
           "reproj_after_mean": float(np.mean(e1))}
    out.append(rec)
    print("  solve {tag}: {wall_s:.4f} s, {iterations} LM its, {cg_iterations} CG its, "
          "{host_syncs} host syncs, capture {capture_s}".format(**rec), flush=True)
    return e1


def solves(dev, tiny):
    """Slices A, B and F's solves: each a first solve on a new solver, then
    the same solve again on it."""
    from sat_bundleadjust_tpu_torch.ba import outliers
    from sat_bundleadjust_tpu_torch.ba.params import BAParams
    from sat_bundleadjust_tpu_torch.ba.solver import BASolver
    from sat_bundleadjust_tpu_torch.utils import demo

    cs = _load_chip_smoke(tiny)
    out = []
    schur = "cg" if tiny else None
    # the process's first calls into the libraries, on a problem of its own
    warm = demo.make_scene_arrays(n_cam=16, n_pts=2000, seed=3, device=dev)
    BASolver(demo.scene_to_baparams(warm), schur_mode=schur, device=dev).solve({"max_iter": 3})

    n_cam, n_pts = (12, 800) if tiny else (50, 20000)
    scene = demo.make_scene_arrays(n_cam=n_cam, n_pts=n_pts, seed=0, device=dev)
    scene["pts2d"], _ = cs.seed_outliers(scene["pts2d"])
    p = demo.scene_to_baparams(scene, dense_c=True)
    s1 = BASolver(p, schur_mode=schur, device=dev)
    e_soft = _solve(s1, cs.SOFT_L1, "A soft-L1", out)
    _solve(s1, cs.SOFT_L1, "A soft-L1 again", out)
    p2 = outliers.rm_outliers(e_soft, p, device=dev)
    s2 = BASolver(p2, schur_mode=schur, device=dev)
    _solve(s2, None, "A L2", out)
    _solve(s2, None, "A L2 again", out)

    n_cam, n_pts = (20, 1500) if tiny else (1000, 200000)
    p = demo.scene_to_baparams(demo.make_scene_arrays(n_cam=n_cam, n_pts=n_pts, seed=0,
                                                      device=dev))
    s = BASolver(p, schur_mode=schur, device=dev)
    ls = {"max_iter": cs.SLICE_B_MAX_ITER}
    _solve(s, ls, "B L2", out)
    _solve(s, ls, "B L2 again", out)

    for tag, model, size in (("F P=11", "perspective", cs.SLICE_F_PERSPECTIVE),
                             ("F P=8", "affine", cs.SLICE_F_AFFINE)):
        if tiny:
            size = dict(size, n_cam=10, n_pts=400)
        m = demo.make_matrix_scene(model, n_views=8, noise_px=0.05, seed=0, **size)
        p = BAParams.from_obs_table(m["pts_ind"], m["cam_ind"], m["pts2d"], m["pts0"],
                                    m["cameras_init"], model, m["camera_centers"], [],
                                    {"verbose": False, "correction_params": cs.SLICE_F_PARAMS})
        s = BASolver(p, schur_mode=schur, device=dev)
        ls = {"max_iter": cs.SLICE_F_MAX_ITER}
        _solve(s, ls, tag, out)
        _solve(s, ls, tag + " again", out)
    return out


def _rounds(infos):
    keys = ("iterations", "cg_iterations", "host_syncs", "capture_s", "graph_replays")
    return [dict({k: r.get(k) for k in keys}, wall_s=r.get("wall_time")) for r in infos]


def clis(dev, scenes, work, tiny, runs=None):
    """The CLI's chain on slice D's frames, on slice E's (ba_sequential,
    ba_global) and with perspective cameras on slice E's first date (the
    first `runs` of these)."""
    import torch

    import sat_bundleadjust_tpu_torch as port

    cs = _load_chip_smoke(tiny)
    d_dir, e_dir = os.path.join(scenes, "d"), os.path.join(scenes, "e")
    runs = [("D", d_dir, dict(cs.SLICE_D_CONFIG)),
            ("E ba_sequential", e_dir, dict(cs.SLICE_E_CONFIG, ba_method="ba_sequential")),
            ("E ba_global", e_dir, dict(cs.SLICE_E_CONFIG, ba_method="ba_global")),
            ("F CLI perspective", e_dir, dict(cs.SLICE_D_CONFIG, cam_model="perspective",
                                              correction_params=cs.SLICE_F_PARAMS,
                                              timeline_indices=[0]))][:runs]
    out = []
    ba_keys = ("soft_l1_s", "outliers_s", "l2_s")
    for n, (tag, img_dir, cfg) in enumerate(runs):
        cfg = dict(cfg, geotiff_dir=img_dir, rpc_dir=img_dir,
                   output_dir=os.path.join(work, "out_{}".format(n)))
        path = os.path.join(work, "config_{}.json".format(n))
        with open(path, "w") as f:
            json.dump(cfg, f)
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        scene = port.main(path, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t0
        if cfg.get("ba_method") == "ba_sequential":
            stages = scene.date_stats["timing"]
            infos = [r for date in scene.date_stats["ba_rounds"] for r in date]
        else:
            pipe = scene.ba_pipeline
            stages, infos = [pipe.timing], pipe.ba_rounds
        rec = {"tag": tag, "cli_s": wall,
               "ba_s": sum(st.get(k, 0.0) for st in stages for k in ba_keys),
               "stages_s": {k: sum(st.get(k, 0.0) for st in stages) for k in ba_keys},
               "rounds": _rounds(infos)}
        out.append(rec)
        print("  CLI {}: {:.3f} s, BA stage {:.3f} s, rounds (LM its, wall, capture) {}".format(
            tag, wall, rec["ba_s"], [(r["iterations"], round(r["wall_s"], 4), r["capture_s"])
                                     for r in rec["rounds"]]), flush=True)
    return out


def _instrument(dev):
    """Wraps BASolver.solve, the LM iteration and the phase capture of
    ops/lm with synchronized timers: each solve's record (wall, LM
    iterations, capture_s, the seconds Python's garbage collector ran, and
    its events: each LM iteration's wall as "eager" or "replay", each
    phase's "capture") is printed and appended to the list returned."""
    import gc

    import torch

    from sat_bundleadjust_tpu_torch.ba import solver as ba_solver
    from sat_bundleadjust_tpu_torch.ops import lm

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    events, gc_s, gc_t0, log = [], [0.0], [0.0], []

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_t0[0]

    gc.callbacks.append(on_gc)

    def timed(name, fn):
        def wrapper(self, *args):
            sync()
            t0 = time.perf_counter()
            out = fn(self, *args)
            sync()
            events.append((name(self) if callable(name) else name, time.perf_counter() - t0))
            return out
        return wrapper

    def solve(self, ls_params=None, verbose=False, graphs=True):
        del events[:]
        gc_s[0] = 0.0
        sync()
        t0 = time.perf_counter()
        out = plain_solve(self, ls_params, verbose, graphs)
        sync()
        info = out[-1]
        rec = {"n_cam": self.p.n_cam, "n_pts": self.p.n_pts, "graphs": graphs,
               "wall_s": time.perf_counter() - t0, "gc_s": gc_s[0],
               "iterations": info["iterations"], "capture_s": info["capture_s"],
               "events": list(events)}
        log.append(rec)
        print("  solve of {} cams, {} tracks{}: {:.4f} s, {} LM its, gc {:.4f} s, capture_s "
              "{:.4f}; {}".format(rec["n_cam"], rec["n_pts"], "" if graphs else " (eager)",
                                  rec["wall_s"], rec["iterations"], rec["gc_s"],
                                  rec["capture_s"], ", ".join("{} {:.4f}".format(n, t)
                                                              for n, t in events)), flush=True)
        return out

    plain_solve = ba_solver.BASolver.solve
    ba_solver.BASolver.solve = solve
    lm._Iteration.one = timed(lambda it: "replay" if it.graphs else "eager", lm._Iteration.one)
    lm._Graph.__init__ = timed("capture", lm._Graph.__init__)
    return log


def probe(tiny, scenes=None):
    """Where the solves' time goes, on this tree (_instrument's records):
    at the CLI's round sizes and at slice A's, two first solves on new
    solvers (as every CLI round is), the same solve again, and graphs=False;
    then, with `scenes` (render's), the CLI's rounds on slice D's and E's
    scenes."""
    from sat_bundleadjust_tpu_torch.ba.solver import BASolver
    from sat_bundleadjust_tpu_torch.utils import demo

    dev = "cpu" if tiny else "cuda"
    schur = "cg" if tiny else None
    warm = demo.make_scene_arrays(n_cam=16, n_pts=2000, seed=3, device=dev)
    BASolver(demo.scene_to_baparams(warm), schur_mode=schur, device=dev).solve({"max_iter": 3})
    log = _instrument(dev)
    ls = {"max_iter": 8}
    for n_cam, n_pts in ((4, 300), (10, 1500), (50, 20000)):
        p = demo.scene_to_baparams(demo.make_scene_arrays(n_cam=n_cam, n_pts=n_pts, seed=0,
                                                          device=dev))
        for run_tag in ("first", "first", "again", "eager"):
            if run_tag == "first":
                solver = BASolver(p, schur_mode=schur, device=dev)
            solver.solve(ls, graphs=run_tag != "eager")
    # the host's time in a first solve at the CLI's round size, by operator
    # and CUDA runtime call (the profiler's own cost included)
    from torch.profiler import ProfilerActivity, profile

    p = demo.scene_to_baparams(demo.make_scene_arrays(n_cam=10, n_pts=10000, seed=1,
                                                      device=dev))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev == "cuda" else [])
    for graphs in (True, False):
        solver = BASolver(p, schur_mode=schur, device=dev)
        with profile(activities=acts) as prof:
            solver.solve(ls, graphs=graphs)
        print("profile of a first solve, graphs={}:\n{}".format(graphs, prof.key_averages().table(
            sort_by="self_cpu_time_total", row_limit=25, max_name_column_width=40)), flush=True)
    if scenes is not None:
        import tempfile

        print("the CLI on slices D and E:", flush=True)
        clis(dev, scenes, tempfile.mkdtemp(prefix="ba_walls_probe_"), tiny, runs=2)
    return log


def run(base, scenes, work, out_path, tiny):
    """One child process's work, on the port of the tree at `base`."""
    sys.path.insert(0, os.path.abspath(base))
    import torch

    import sat_bundleadjust_tpu_torch as port

    here = os.path.dirname(os.path.abspath(port.__file__))
    assert here == os.path.join(os.path.abspath(base), "sat_bundleadjust_tpu_torch"), here
    dev = "cpu" if tiny else "cuda"
    if not tiny:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(work, exist_ok=True)
    print("port from {}".format(here), flush=True)
    rec = {"port": here, "solves": solves(dev, tiny), "clis": clis(dev, scenes, work, tiny)}
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)


def _median(xs):
    xs = sorted(x for x in xs if x is not None)
    if not xs:
        return None
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def compare(paths):
    """Prints each solve's, CLI's and BA round's walls in every run, the
    medians of base and this tree, and the share of solves (the BA rounds
    of the CLIs included) where this tree's median is the larger."""
    runs = []
    for path in paths:
        with open(path) as f:
            runs.append((os.path.basename(path).rsplit("_", 1)[0], json.load(f)))
    rows = []
    for i, s in enumerate(runs[0][1]["solves"]):
        rows.append(("solve " + s["tag"], [(lab, r["solves"][i]["wall_s"]) for lab, r in runs],
                     True))
    for i, c in enumerate(runs[0][1]["clis"]):
        rows.append(("CLI " + c["tag"], [(lab, r["clis"][i]["cli_s"]) for lab, r in runs], False))
        rows.append(("CLI {} BA stage".format(c["tag"]),
                     [(lab, r["clis"][i]["ba_s"]) for lab, r in runs], False))
        for j in range(len(c["rounds"])):
            walls = [(lab, r["clis"][i]["rounds"][j]["wall_s"] if j < len(r["clis"][i]["rounds"])
                      else None) for lab, r in runs]
            rows.append(("CLI {} round {} ({} its)".format(c["tag"], j + 1,
                                                         c["rounds"][j]["iterations"]),
                         walls, True))
    slower = total = 0
    print("| what | " + " | ".join(lab for lab, _ in runs) + " | base median | change median |")
    print("|---|" + "---|" * (len(runs) + 2))
    for name, walls, is_solve in rows:
        b = _median([w for lab, w in walls if lab == "base"])
        c = _median([w for lab, w in walls if lab == "change"])
        print("| {} | {} | {} | {} |".format(
            name, " | ".join("{:.4f}".format(w) if w is not None else "-" for _, w in walls),
            "{:.4f}".format(b) if b is not None else "-",
            "{:.4f}".format(c) if c is not None else "-"))
        if is_solve and b is not None and c is not None:
            total += 1
            slower += c > b
    print("solves where this tree's median wall is the larger: {} of {}".format(slower, total))
    return slower, total


def ab(base, out, tiny):
    """Build both trees' kernels, render the scenes, run base, this tree,
    this tree, base, and compare."""
    import shutil
    import tempfile

    os.makedirs(out, exist_ok=True)
    here = os.path.abspath(__file__)
    tmp = tempfile.mkdtemp(prefix="ba_walls_")
    t0 = time.time()
    if not tiny:
        builds = [subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
             "from sat_bundleadjust_tpu_torch.ops import _build; _build.build()", root])
            for root in (base, REPO)]
        assert all(p.wait(timeout=CHILD_TIMEOUT_S) == 0 for p in builds), "a build failed"
    print("kernels built in {:.1f} s".format(time.time() - t0), flush=True)
    scenes = os.path.join(tmp, "scenes")
    tiny_arg = ["--tiny"] if tiny else []
    subprocess.run([sys.executable, here, "render", "--scenes", scenes] + tiny_arg, check=True,
                   timeout=CHILD_TIMEOUT_S, cwd=REPO)
    paths = []
    for n, (label, root) in enumerate((("base", base), ("change", REPO), ("change", REPO),
                                       ("base", base))):
        path = os.path.join(out, "{}_{}.json".format(label, n))
        with open(os.path.join(out, "{}_{}.log".format(label, n)), "w") as log:
            t1 = time.time()
            subprocess.run([sys.executable, here, "run", "--base", root, "--scenes", scenes,
                            "--work", os.path.join(tmp, "work_{}".format(n)), "--json", path]
                           + tiny_arg, check=True, timeout=CHILD_TIMEOUT_S, cwd=REPO,
                           stdout=log, stderr=subprocess.STDOUT)
        print("{} ({}) in {:.1f} s".format(label, root, time.time() - t1), flush=True)
        paths.append(path)
    shutil.rmtree(tmp, ignore_errors=True)
    compare(paths)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["ab", "render", "run", "compare", "probe"])
    ap.add_argument("--base", help="root of the tree to compare against (ab) or to run (run)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "ba_walls"))
    ap.add_argument("--scenes")
    ap.add_argument("--work")
    ap.add_argument("--json")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("paths", nargs="*")
    a = ap.parse_args()
    if a.mode == "ab":
        ab(os.path.abspath(a.base), os.path.abspath(a.out), a.tiny)
    elif a.mode == "render":
        render(a.scenes, a.tiny)
    elif a.mode == "run":
        run(a.base, a.scenes, a.work, a.json, a.tiny)
    elif a.mode == "probe":
        sys.path.insert(0, REPO)
        if a.scenes:
            render(a.scenes, a.tiny)
        rec = probe(a.tiny, a.scenes)
        if a.json:
            with open(a.json, "w") as f:
                json.dump(rec, f, indent=1)
    else:
        compare(a.paths)


if __name__ == "__main__":
    main()
