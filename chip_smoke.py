#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sat_bundleadjust_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out record.json]

Needs one NVIDIA GPU and the CUDA toolkit (nvcc); it exits non-zero, with
no result line, where CUDA is not available. It

  1. prints the card, its power limit, the torch/CUDA versions, and asserts
     that TF32 is off;
  2. builds every CUDA kernel of the port from csrc/ (one nvcc per source,
     all at once) and prints the build time;
  3. holds each kernel against its plain PyTorch version (and the Schur
     operator against its "aos" form) at the operands of the first LM step
     of both problems below, checks that two launches give the same bits,
     and times kernel and plain version with CUDA events;
  4. slice A: the pipeline's bundle-adjustment stage on the 50-camera demo
     problem (20 000 tracks, 80 000 observations, 2% of them moved by
     10-30 px): C-matrix problem, soft-L1 solve, outlier removal with
     re-triangulation, L2 solve, reconstruct_vars;
  5. slice B: an L2 solve at the 1000-camera time-series scale (200 000
     tracks, 800 000 observations), which must end at a mean reprojection
     error of at most 0.100 px;
  6. re-runs the L2 solve of each slice under torch.profiler and prints
     the device's busy time per LM iteration, its idle share and the
     kernels that take the device time;
  7. solves a 16-camera problem on the CPU (plain operator) and on the
     card (kernel), which must agree;

and ends with a JSON line per kernel ({"kernels": [...]}) and the result
line {"ok": true, "device": {...}}. Kernel launch counters are set to 0
just before each slice and read just after it: a kernel of the path that
a slice did not launch fails the run.
"""

import argparse
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth; f32 and f64 rates
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12

SOFT_L1 = {"loss": "soft_l1", "f_scale": 1.0, "max_iter": 300}
SLICE_B_MAX_ITER = 30
SLICE_B_MAX_REPROJ = 0.100


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps, rounds=7):
    """Median over rounds of the mean time per call of fn (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


def schur_operands(p, solver, lam=1e-4):
    """The CG operator's operands at the first LM step of a solve (the
    state bench.py checks the TPU kernel at), scaled as the CG scales
    them: What in both layouts."""
    import torch

    from sat_bundleadjust_tpu_torch.ops import lm

    dev, prob = solver.device, solver.prob
    cam0 = torch.as_tensor(p.opt_block(), device=dev)
    pts0 = torch.as_tensor(p.pts3d, device=dev)
    r, J_cam, J_pt = solver.jac_fn(cam0, pts0)
    cfg = lm.LMConfig(schur_mode="cg")
    _, g_cam, g_pt, _, V, W = lm._normal_blocks(r, J_cam, J_pt, prob, p.n_cam, p.n_pts, cfg)
    Vinv = lm._inv3x3(lm._damp(V, lam))
    scale = lm._schur_rhs(g_cam, g_pt, W, Vinv, prob, p.n_cam).abs().max()
    W_pt, W_cm = lm.fold_layouts((W / torch.sqrt(scale)).float(), Vinv.float(), prob)
    return W_pt, prob.cam_ind_pt, W_cm, prob.pts_ind_cam


def check_schur_wz(tag, p, solver):
    """Kernel vs plain version vs aos form, repeatability, times, bound."""
    import torch

    from sat_bundleadjust_tpu_torch.ops import lm
    from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv

    args = schur_operands(p, solver)
    W_pt, cam_ind_pt, W_cm, pts_ind_cam = args
    M, P = p.n_cam, p.n_params
    x = torch.randn(M, P, dtype=torch.float32, device=solver.device,
                    generator=torch.Generator(solver.device).manual_seed(0))
    wz1 = smv.schur_wz(x, *args)
    wz2 = smv.schur_wz(x, *args)
    plain = smv.schur_wz_plain(x, *args)
    aos = lm.schur_wz_aos(x, *args)
    torch.cuda.synchronize()
    scale = float(plain.abs().max())
    err_plain = float((wz1 - plain).abs().max())
    err_aos = float((wz1 - aos).abs().max())
    same_bits = bool(torch.equal(wz1, wz2))
    assert bool(torch.isfinite(wz1).all()), "schur_wz: non-finite output"
    assert err_plain <= 2e-6 * scale, (tag, err_plain / scale)
    assert err_aos <= 5e-5 * scale, (tag, err_aos / scale)
    assert same_bits, "schur_wz: two launches differ"

    K = p.n_obs
    reps = 200 if K < 200_000 else 50
    ms = cuda_ms(lambda: smv.schur_wz(x, *args), reps)
    plain_ms = cuda_ms(lambda: smv.schur_wz_plain(x, *args), max(reps // 10, 5))
    # least work: x, both What layouts at the K real observations, both
    # index tables, wz; K*P*3 f32 FMAs (track side) and K*P*3 f64 FMAs
    # (camera side)
    nbytes = 4 * (2 * M * P + 2 * K * P * 3 + cam_ind_pt.numel() + pts_ind_cam.numel())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (2 * K * P * 3 / PEAK_F32_PER_S + 2 * K * P * 3 / PEAK_F64_PER_S) * 1e3
    rec = {
        "shape": {"M": M, "N": p.n_pts, "K": K, "P": P, "Tp": int(cam_ind_pt.shape[1]),
                  "Tc": int(pts_ind_cam.shape[1])},
        "max_abs_err": err_plain, "rel_err_plain": err_plain / scale,
        "rel_err_aos": err_aos / scale, "bit_identical": same_bits,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes,
    }
    log("schur_wz [{}] M={M} N={N} K={K} P={P} Tp={Tp} Tc={Tc}: vs plain {:.2e}, vs aos {:.2e} "
        "of max|wz|, bit-identical {}; kernel {:.4f} ms, plain {:.4f} ms, bound {:.4f} ms "
        "({:.1f} MB)".format(tag, rec["rel_err_plain"], rec["rel_err_aos"], same_bits, ms,
                             plain_ms, rec["bound_ms"], nbytes / 1e6, **rec["shape"]))
    return rec


def solve_round(solver, ls, label):
    import numpy as np
    import torch

    from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv

    torch.cuda.synchronize()
    launches0 = smv.schur_wz.launches
    t0 = time.time()
    _, (cam, pts), e0, e1, info = solver.solve(ls)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = smv.schur_wz.launches - launches0
    rec = {
        "iterations": info["iterations"], "wall_s": wall,
        "lm_it_per_s": info["iterations"] / wall,
        "reproj_before_mean": float(np.mean(e0)), "reproj_before_median": float(np.median(e0)),
        "reproj_after_mean": float(np.mean(e1)), "reproj_after_median": float(np.median(e1)),
        "host_syncs": info["host_syncs"], "cg_iterations": info["cg_iterations"],
        "matvecs": info["matvecs"], "kernel_launches": launches, "mode": solver.mode,
    }
    assert np.all(np.isfinite(e1)) and e1.shape == (solver.p.n_obs,)
    assert launches == info["matvecs"] > 0, (label, launches, info["matvecs"])
    log("{}: {} LM iterations in {:.3f} s ({:.2f} it/s); reprojection mean/median "
        "{:.4f}/{:.4f} -> {:.4f}/{:.4f} px; {} host syncs, {} CG iterations, {} matvecs, "
        "{} schur_wz launches".format(
            label, rec["iterations"], wall, rec["lm_it_per_s"], rec["reproj_before_mean"],
            rec["reproj_before_median"], rec["reproj_after_mean"], rec["reproj_after_median"],
            rec["host_syncs"], rec["cg_iterations"], rec["matvecs"], launches))
    return cam, pts, e1, rec


def profile_window(label, solver, ls, wall_per_it):
    """Re-run a solve under torch.profiler: device busy time (the union of
    the kernels' spans), kernels per LM iteration, the operator kernels'
    share of device time, and the device's idle share against wall_per_it,
    the unprofiled wall time per LM iteration of the main-path run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        *_, info = solver.solve(ls)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kern, "{}: the profiler saw no device activity".format(label)
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for e in sorted(kern, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    total_us = sum(by_name.values())
    schur_us = sum(v for k, v in by_name.items() if "point_pass" in k or "camera_pass" in k)
    its = max(info["iterations"], 1)
    busy_ms_per_it = busy_us / 1e3 / its
    rec = {"iterations": info["iterations"], "device_busy_ms_per_it": busy_ms_per_it,
           "kernels_per_it": len(kern) / its, "schur_wz_share": schur_us / total_us,
           "idle_share": 1.0 - busy_ms_per_it / (wall_per_it * 1e3),
           "top": sorted(((v / total_us, k[:60]) for k, v in by_name.items()), reverse=True)[:6]}
    log("profile [{}]: {} LM iterations; device busy {:.3f} ms per LM iteration against "
        "{:.3f} ms of wall (idle share {:.1%}); {:.0f} device kernels per LM iteration; "
        "schur_wz {:.1%} of device time; top: {}".format(
            label, its, busy_ms_per_it, wall_per_it * 1e3, rec["idle_share"],
            rec["kernels_per_it"], rec["schur_wz_share"],
            "; ".join("{:.1%} {}".format(*x) for x in rec["top"])))
    return rec


def seed_outliers(pts2d, frac=0.02, seed=5):
    """Move frac of the observations by 10-30 px in a random direction."""
    import numpy as np

    rng = np.random.RandomState(seed)
    k = rng.choice(len(pts2d), int(frac * len(pts2d)), replace=False)
    ang = rng.uniform(0, 2 * np.pi, len(k))
    mag = rng.uniform(10.0, 30.0, len(k))
    out = np.array(pts2d)
    out[k] += np.stack([np.cos(ang), np.sin(ang)], axis=1) * mag[:, None]
    return out, k


def slice_a(dev, kernels):
    """Steps 7-10 of the pipeline on the 50-camera demo problem."""
    import numpy as np
    import torch

    from sat_bundleadjust_tpu_torch.ba import outliers
    from sat_bundleadjust_tpu_torch.ba.solver import BASolver
    from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv
    from sat_bundleadjust_tpu_torch.utils import demo

    t0 = time.time()
    scene = demo.make_scene_arrays(n_cam=50, n_pts=20000, seed=0, device=dev)
    scene["pts2d"], seeded = seed_outliers(scene["pts2d"])
    p = demo.scene_to_baparams(scene, dense_c=True)
    solver = BASolver(p, device=dev)
    setup_s = time.time() - t0
    log("slice A: {} cams, {} tracks, {} obs ({} moved by 10-30 px), set-up {:.2f} s".format(
        p.n_cam, p.n_pts, p.n_obs, len(seeded), setup_s))
    kernels["A"] = check_schur_wz("slice A", p, solver)
    # first calls into cuBLAS/cuSOLVER and the allocator's warm-up stay out
    # of the timed rounds
    solver.solve({"max_iter": 2})

    for k in kernels["counters"]:
        k.launches = 0
    t_stage = time.time()
    _, _, e_soft, soft = solve_round(solver, SOFT_L1, "slice A soft-L1")
    t0 = time.time()
    _, _, n_flagged = outliers.compute_obs_to_remove(e_soft, p)
    p2 = outliers.rm_outliers(e_soft, p, device=dev)
    torch.cuda.synchronize()
    rm_s = time.time() - t0
    seeded_pairs = set(zip(scene["cam_ind"][seeded].tolist(), scene["pts_ind"][seeded].tolist()))
    kept = set(zip(p2.cam_ind.tolist(), p2.pts_prev_indices[p2.pts_ind].tolist()))
    recall = 1.0 - len(seeded_pairs & kept) / len(seeded_pairs)
    log("slice A outliers: {} flagged, {} observations removed with their tracks "
        "({} -> {}), {:.1%} of the moved ones removed, {:.3f} s".format(
            n_flagged, p.n_obs - p2.n_obs, p.n_obs, p2.n_obs, recall, rm_s))
    solver2 = BASolver(p2, device=dev)
    cam, pts, e_l2, l2 = solve_round(solver2, None, "slice A L2")
    corrected_pts, corrected_cams = p2.reconstruct_vars(cam, pts, p.pts3d, p.cameras)
    stage_s = time.time() - t_stage
    launches = {k.__name__: k.launches for k in kernels["counters"]}
    assert all(n > 0 for n in launches.values()), launches
    assert launches["schur_wz"] == soft["matvecs"] + l2["matvecs"], launches
    assert np.all(np.isfinite(corrected_pts)) and corrected_pts.shape == p.pts3d.shape
    assert len(corrected_cams) == p.n_cam
    assert recall >= 0.9, recall
    assert l2["reproj_after_mean"] < 0.15, l2["reproj_after_mean"]
    log("slice A: BA stage {:.3f} s; kernel launches {}".format(stage_s, launches))
    prof = profile_window("slice A L2", solver2, None, l2["wall_s"] / l2["iterations"])
    return {"profile": prof, "soft_l1": soft, "l2": l2, "flagged": n_flagged, "removed": p.n_obs - p2.n_obs,
            "moved": len(seeded), "moved_removed_share": recall, "outlier_s": rm_s,
            "stage_s": stage_s, "launches": launches}


def slice_b(dev, kernels):
    """An L2 solve at the 1000-camera scale."""
    import torch

    from sat_bundleadjust_tpu_torch.ba.solver import BASolver
    from sat_bundleadjust_tpu_torch.utils import demo

    t0 = time.time()
    scene = demo.make_scene_arrays(n_cam=1000, n_pts=200000, seed=0, device=dev)
    p = demo.scene_to_baparams(scene)
    solver = BASolver(p, device=dev)
    torch.cuda.synchronize()
    log("slice B: {} cams, {} tracks, {} obs, set-up {:.2f} s".format(
        p.n_cam, p.n_pts, p.n_obs, time.time() - t0))
    kernels["B"] = check_schur_wz("slice B", p, solver)

    for k in kernels["counters"]:
        k.launches = 0
    _, _, _, l2 = solve_round(solver, {"max_iter": SLICE_B_MAX_ITER}, "slice B L2")
    launches = {k.__name__: k.launches for k in kernels["counters"]}
    assert all(n > 0 for n in launches.values()), launches
    assert l2["reproj_after_mean"] <= SLICE_B_MAX_REPROJ, l2["reproj_after_mean"]
    log("slice B: max_iter {} (not cut); kernel launches {}".format(SLICE_B_MAX_ITER, launches))
    prof = profile_window("slice B L2, first 5 LM iterations", solver, {"max_iter": 5},
                          l2["wall_s"] / l2["iterations"])
    return {"profile": prof, "l2": l2, "launches": launches}


def small_reference(dev):
    """The same 16-camera CG solve through the plain operator on the CPU and
    through the kernel on the card."""
    import numpy as np

    from sat_bundleadjust_tpu_torch.ba.solver import BASolver
    from sat_bundleadjust_tpu_torch.utils import demo

    scene = demo.make_scene_arrays(n_cam=16, n_pts=2000, seed=3, device="cpu")
    p = demo.scene_to_baparams(scene)
    out = {}
    for d in ("cpu", dev):
        _, _, _, e1, info = BASolver(p, schur_mode="cg", device=d).solve({"max_iter": 50})
        out[str(d)] = (float(np.mean(e1)), info["iterations"])
    (e_cpu, it_cpu), (e_gpu, it_gpu) = out["cpu"], out[str(dev)]
    log("small reference (16 cams, CG): cpu/plain {:.6f} px in {} it, card/kernel {:.6f} px "
        "in {} it".format(e_cpu, it_cpu, e_gpu, it_gpu))
    assert abs(e_cpu - e_gpu) <= 1e-3 and abs(it_cpu - it_gpu) <= 2, out
    return {"cpu": out["cpu"], "cuda": out[str(dev)]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the full record as JSON to this file")
    args = ap.parse_args()
    t_start = time.time()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2

    import sat_bundleadjust_tpu_torch  # noqa: F401  (pins the precision flags)
    from sat_bundleadjust_tpu_torch.ops import _build
    from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log("python {} torch {} cuda {}".format(sys.version.split()[0], torch.__version__,
                                           torch.version.cuda))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    log("precision: matmul.allow_tf32={} cudnn.allow_tf32={} float32_matmul_precision={}"
        .format(*flags))
    assert flags == (False, False, "highest"), flags
    dev = torch.device("cuda")

    t0 = time.time()
    _build.build()
    build_s = time.time() - t0
    log("kernel build: {} in {:.2f} s (one nvcc per source, in parallel)".format(
        _build.sources(), build_s))

    kernels = {"counters": [smv.schur_wz]}
    rec = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
           "build_s": build_s}
    rec["slice_a"] = slice_a(dev, kernels)
    rec["slice_b"] = slice_b(dev, kernels)
    rec["small_reference"] = small_reference(dev)
    rec["schur_wz"] = {"A": kernels["A"], "B": kernels["B"]}
    rec["total_s"] = time.time() - t_start
    log("total {:.1f} s".format(rec["total_s"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)

    b = kernels["B"]
    line = {"kernels": [{
        "name": "schur_wz", "route": "cuda",
        "source": "sat_bundleadjust_tpu_torch/csrc/schur_matvec.cu",
        "replaces": "sat_bundleadjust_tpu/ops/pallas_matvec.py:263",
        "launches": rec["slice_a"]["launches"]["schur_wz"] + rec["slice_b"]["launches"]["schur_wz"],
        "max_abs_err": max(kernels["A"]["max_abs_err"], b["max_abs_err"]),
        "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"], "library_ms": None,
        "at": "slice B shape (M=1000, K=800000); slice A: ms {:.5f}, plain_ms {:.5f}, "
              "bound_ms {:.5f}".format(kernels["A"]["ms"], kernels["A"]["plain_ms"],
                                       kernels["A"]["bound_ms"]),
    }]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
