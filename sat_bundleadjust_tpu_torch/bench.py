"""Benchmark of the port: bundle-adjustment solver throughput on the card
against the reference algorithm (scipy least_squares TRF with
finite-difference Jacobians), or feature-tracking throughput.

    python -m sat_bundleadjust_tpu_torch.bench

Counterpart of the repository's `bench.py`, function by function, with the
same problem, the same environment variables and the same output: ONE JSON
line as the last line of stdout,

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

ba mode (SATBA_BENCH_MODE unset or "ba"):
  value       = LM iterations/second of the CG Schur solver on the standard
                problem (SATBA_BENCH_CAMS 50 cameras, SATBA_BENCH_PTS 20 000
                tie points, SATBA_BENCH_OBS 4 observations each;
                SATBA_BENCH_SCHUR "cg"), the median of five timed solves;
  vs_baseline = wall-clock speedup of a full solve against the scipy TRF
                pipeline on the same problem on the host's CPU, run at full
                size up to SATBA_BENCH_BASELINE_MAX_OBS observations
                (100 000), else at 2000 points and scaled linearly.
  Before timing, the Schur operator kernel is held against its plain
  version (f64 camera sums) and the aos form at the first LM step's
  operands; a difference above 2e-6 or 5e-5 of max|wz| fails the run.

tracks mode (SATBA_BENCH_MODE=tracks):
  value       = tracks/second of SIFT detection, batched 2-NN matching of
                all pairs, RANSAC and the union-find tracks on
                SATBA_BENCH_IMAGES (6) rendered views of SATBA_BENCH_H x
                SATBA_BENCH_W (300 x 400) px, SATBA_BENCH_KP (3000)
                keypoints a view at most, after one warm-up pass;
  vs_baseline = against the same detection plus a numpy brute-force 2-NN
                of one pair, scaled to all pairs.

It runs on the CUDA card and raises where CUDA is not available;
SATBA_BENCH_PLATFORM=cpu asks for the CPU (the kernels' plain versions).
"""

import json
import os
import sys
import time

import numpy as np
import torch

GATE_PLAIN = 2e-6
GATE_AOS = 5e-5


def _note(rec, msg):
    """A line of the run's report: on stderr, and kept in rec["log"]."""
    print(msg, file=sys.stderr, flush=True)
    rec.setdefault("log", []).append(msg)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _platform(dev):
    return "cuda " + torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def bench_device():
    """The device of a run: the CPU where SATBA_BENCH_PLATFORM=cpu asks for
    it, else the CUDA card (resolve_device raises without CUDA)."""
    from sat_bundleadjust_tpu_torch import resolve_device

    return resolve_device("cpu" if os.environ.get("SATBA_BENCH_PLATFORM") == "cpu" else None)


def numpy_reference_solver(scene, max_nfev=20):
    """The reference's solver strategy on the same problem, in numpy/scipy:
    residual = project(adjust_pts3d(X)) - obs through the same RPC math,
    finite-difference Jacobian with sparsity grouping, TRF."""
    from scipy.optimize import least_squares
    from scipy.sparse import lil_matrix

    pts_ind = scene["pts_ind"]
    cam_ind = scene["cam_ind"]
    pts2d = scene["pts2d"]
    n_cam = scene["cam_params0"].shape[0]
    n_pts = scene["pts3d"].shape[0]
    rpcs = scene["rpc_list"]
    cam_const = scene["cam_params0"][:, 3:]  # T, C fixed; only R optimized

    # numpy RPC projection chain (reference math: ba_core.py:110-154,
    # cam_utils.py:217-231, geo_utils.py:236-255)
    def ecef_to_latlon(x, y, z):
        a = 6378137.0
        e = 8.1819190842622e-2
        asq, esq = a ** 2, e ** 2
        b = np.sqrt(asq * (1 - esq))
        ep = np.sqrt((asq - b ** 2) / b ** 2)
        p = np.sqrt(x ** 2 + y ** 2)
        th = np.arctan2(a * z, b * p)
        lon = np.arctan2(y, x)
        lat = np.arctan2(z + ep ** 2 * b * np.sin(th) ** 3, p - esq * a * np.cos(th) ** 3)
        n = a / np.sqrt(1 - esq * np.sin(lat) ** 2)
        alt = p / np.cos(lat) - n
        return np.degrees(lat), np.degrees(lon), alt

    def rotate_euler_np(pts, ang):
        cx, sx = np.cos(ang[:, 0]), np.sin(ang[:, 0])
        cy, sy = np.cos(ang[:, 1]), np.sin(ang[:, 1])
        cz, sz = np.cos(ang[:, 2]), np.sin(ang[:, 2])
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        y, z = cx * y - sx * z, sx * y + cx * z
        x, z = cy * x + sy * z, -sy * x + cy * z
        x, y = cz * x - sz * y, sz * x + cz * y
        return np.stack([x, y, z], axis=1)

    def project_rpc_np(rpc, lon, lat, alt):
        L = (lon - float(rpc.lon_offset)) / float(rpc.lon_scale)
        P = (lat - float(rpc.lat_offset)) / float(rpc.lat_scale)
        H = (alt - float(rpc.alt_offset)) / float(rpc.alt_scale)

        def poly(c):
            c = np.asarray(c)
            terms = [
                np.ones_like(L), L, P, H, L * P, L * H, P * H, L * L, P * P, H * H,
                L * P * H, L ** 3, L * P * P, L * H * H, L * L * P, P ** 3,
                P * H * H, L * L * H, P * P * H, H ** 3,
            ]
            return sum(ci * ti for ci, ti in zip(c, terms))

        col = poly(rpc.samp_num) / poly(rpc.samp_den) * float(rpc.col_scale) + float(rpc.col_offset)
        row = poly(rpc.line_num) / poly(rpc.line_den) * float(rpc.row_scale) + float(rpc.row_offset)
        return col, row

    def fun(v):
        cam_R = v[: n_cam * 3].reshape(n_cam, 3)
        pts3d = v[n_cam * 3:].reshape(n_pts, 3)
        full = np.hstack([cam_R, cam_const])
        P = full[cam_ind]
        X = pts3d[pts_ind]
        Xc = X - P[:, 3:6] - P[:, 6:9]
        Xr = rotate_euler_np(Xc, P[:, :3]) + P[:, 6:9]
        lat, lon, alt = ecef_to_latlon(Xr[:, 0], Xr[:, 1], Xr[:, 2])
        proj = np.zeros((len(cam_ind), 2))
        for c in range(n_cam):
            sel = cam_ind == c
            col, row = project_rpc_np(rpcs[c], lon[sel], lat[sel], alt[sel])
            proj[sel, 0] = col
            proj[sel, 1] = row
        return (proj - pts2d).ravel()

    # jacobian sparsity (reference: ba_core.py:186-219)
    m = len(cam_ind) * 2
    n = n_cam * 3 + n_pts * 3
    A = lil_matrix((m, n), dtype=int)
    i = np.arange(len(cam_ind))
    for s in range(3):
        A[2 * i, cam_ind * 3 + s] = 1
        A[2 * i + 1, cam_ind * 3 + s] = 1
        A[2 * i, n_cam * 3 + pts_ind * 3 + s] = 1
        A[2 * i + 1, n_cam * 3 + pts_ind * 3 + s] = 1

    rng = np.random.RandomState(1)
    v0 = np.concatenate([np.zeros(n_cam * 3), (scene["pts3d"] + rng.randn(n_pts, 3)).ravel()])
    t0 = time.time()
    res = least_squares(
        fun, v0, jac_sparsity=A, x_scale="jac", method="trf",
        ftol=1e-4, xtol=1e-10, max_nfev=max_nfev, verbose=0,
    )
    elapsed = time.time() - t0
    err = np.linalg.norm(res.fun.reshape(-1, 2), axis=1)
    return elapsed, res.nfev, float(np.mean(err))


def _numpy_2nn_match(d1, d2):
    """Reference-equivalent brute-force 2-NN matcher (opencv BFMatcher
    algorithm, ft_opencv.py:200-208) in numpy, for the tracks baseline."""
    n1 = (d1 ** 2).sum(1)[:, None]
    n2 = (d2 ** 2).sum(1)[None, :]
    dist = n1 + n2 - 2.0 * (d1 @ d2.T)
    part = np.partition(dist, 1, axis=1)[:, :2]
    return part


def bench_tracks(dev):
    """Feature-tracking throughput on `dev`: SIFT detection + pairwise
    matching + track building on rendered multi-view imagery, after one
    warm-up pass. Returns (result, record): the four keys of the JSON line,
    and the run's sizes, times, tracks count and report lines."""
    from sat_bundleadjust_tpu_torch.ops.match import _finalize_matches, match_pairs_2nn_batched
    from sat_bundleadjust_tpu_torch.ops.sift import detect_sift_batch
    from sat_bundleadjust_tpu_torch.tracks.build import feature_tracks_from_pairwise_matches
    from sat_bundleadjust_tpu_torch.utils.demo import render_synthetic_images

    n_im = int(os.environ.get("SATBA_BENCH_IMAGES", 6))
    h = int(os.environ.get("SATBA_BENCH_H", 300))
    w = int(os.environ.get("SATBA_BENCH_W", 400))
    max_kp = int(os.environ.get("SATBA_BENCH_KP", 3000))
    images, _ = render_synthetic_images(n_cam=n_im, h=h, w=w, seed=0, device=dev)
    pairs = [(i, j) for i in range(n_im) for j in range(i + 1, n_im)]

    stages = {}

    def match_all(feats):
        """All pairs in one batched 2-NN call (the pipeline's single-card
        path, tracks/matching.py; on the card the int8 kernel with its
        epipolar gate off), then host RANSAC. Their walls go to stages."""
        t = time.time()
        nn_results = match_pairs_2nn_batched(
            [(feats[i], feats[j]) for (i, j) in pairs], [None] * len(pairs), device=dev)
        _sync(dev)
        stages["nn_s"] = time.time() - t
        t = time.time()
        pm = []
        for (i, j), (nn, acc) in zip(pairs, nn_results):
            m, _, _ = _finalize_matches(feats[i], feats[j], nn, acc, 0.3)
            if m is not None and len(m):
                pm.append(np.hstack([
                    m, np.full((len(m), 1), i, np.int64), np.full((len(m), 1), j, np.int64)
                ]))
        _sync(dev)
        stages["ransac_s"] = time.time() - t
        return np.concatenate(pm)

    # the first calls into each kernel, the kernel build and the allocator
    # stay out of the timed pass
    match_all(detect_sift_batch(images, max_kp=max_kp, device=dev))

    _sync(dev)
    t0 = time.time()
    feats = detect_sift_batch(images, max_kp=max_kp, device=dev)
    _sync(dev)
    det_time = time.time() - t0
    pm = match_all(feats)
    t1 = time.time()
    C, _ = feature_tracks_from_pairwise_matches(feats, pm, pairs)
    _sync(dev)
    stages["tracks_s"] = time.time() - t1
    elapsed = time.time() - t0
    n_tracks = C.shape[1]

    # baseline: the same detection time + numpy brute-force 2-NN on one
    # pair, scaled to all pairs
    base_det = det_time
    t1 = time.time()
    _numpy_2nn_match(feats[0][:, 4:].astype(np.float64), feats[1][:, 4:].astype(np.float64))
    base_match = (time.time() - t1) * len(pairs)
    base_label = "numpy-2NN"
    vs_baseline = (base_det + base_match) / elapsed

    rec = {"images": n_im, "h": h, "w": w, "max_kp": max_kp, "pairs": len(pairs),
           "keypoints": [int(f.shape[0]) for f in feats], "matches": int(pm.shape[0]),
           "tracks": int(n_tracks), "elapsed_s": elapsed, "detection_s": det_time, **stages,
           "baseline": base_label, "baseline_detection_s": base_det,
           "baseline_matching_s": base_match}
    _note(rec, "tracks: {} images {}x{}, {} kp/im cap -> {} tracks in {:.2f}s "
               "({:.2f}s detection); {} baseline {:.2f}s detection + {:.2f}s matching".format(
                   n_im, h, w, max_kp, n_tracks, elapsed, det_time,
                   base_label, base_det, base_match))
    _note(rec, "tracks stages: detection {:.3f}s, 2-NN {:.3f}s, RANSAC {:.3f}s, tracks {:.3f}s".format(
        det_time, stages["nn_s"], stages["ransac_s"], stages["tracks_s"]))
    result = {
        "metric": "feature_tracks_per_second",
        "value": round(n_tracks / elapsed, 3),
        "unit": "tracks/s ({} images {}x{}, {})".format(n_im, h, w, _platform(dev)),
        "vs_baseline": round(vs_baseline, 2),
    }
    return result, rec


def schur_operands(solver):
    """The CG operator's operands at the first LM step of a solve (V damped
    by 1e-4), scaled as the CG scales them: (W_pt, cam_ind_pt, W_cm,
    pts_ind_cam), the arguments of ops/schur_matvec.schur_wz after x. Needs
    the problem's dual layouts (solver.prob.cam_ind_pt not None)."""
    from sat_bundleadjust_tpu_torch.ops import lm

    p, dev, prob = solver.p, solver.device, solver.prob
    cam0 = torch.as_tensor(p.opt_block(), device=dev)
    pts0 = torch.as_tensor(p.pts3d, device=dev)
    r, J_cam, J_pt = solver.jac_fn(cam0, pts0)
    cfg = lm.LMConfig(schur_mode="cg")
    _, g_cam, g_pt, _, V, W = lm._normal_blocks(r, J_cam, J_pt, prob, p.n_cam, p.n_pts, cfg)
    Vinv = lm._inv3x3(lm._damp(V, 1e-4))
    scale = lm._schur_rhs(g_cam, g_pt, W, Vinv, prob, p.n_cam).abs().max()
    W_pt, W_cm = lm.fold_layouts((W / torch.sqrt(scale)).float(), Vinv.float(), prob)
    return W_pt, prob.cam_ind_pt, W_cm, prob.pts_ind_cam


def schur_gate(solver, seed=0):
    """The Schur operator kernel (ops/schur_matvec.schur_wz) against its
    plain version (f64 camera sums) and the aos form (ops/lm.schur_wz_aos)
    at the operands of the solver's first LM step, on a seeded x. Returns
    the two differences relative to max|wz| of the plain version and the
    number of schur_wz calls made (each a launch on the card); raises when
    either difference is above its limit (GATE_PLAIN, GATE_AOS)."""
    from sat_bundleadjust_tpu_torch.ops.lm import schur_wz_aos
    from sat_bundleadjust_tpu_torch.ops.schur_matvec import schur_wz, schur_wz_plain

    p = solver.p
    args = schur_operands(solver)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(p.n_cam, p.n_params)), dtype=torch.float32,
                        device=solver.device)
    wz = schur_wz(x, *args).clone()
    plain = schur_wz_plain(x, *args)
    aos = schur_wz_aos(x, *args)
    scale = max(float(plain.abs().max()), 1e-30)
    err_plain = float((wz - plain).abs().max()) / scale
    err_aos = float((wz - aos).abs().max()) / scale
    if not (err_plain <= GATE_PLAIN and err_aos <= GATE_AOS):
        raise RuntimeError("schur_wz parity gate failed: {:.3e} of max|wz| from the plain "
                           "version (limit {:.0e}), {:.3e} from the aos form (limit {:.0e})"
                           .format(err_plain, GATE_PLAIN, err_aos, GATE_AOS))
    return {"vs_plain": err_plain, "vs_aos": err_aos, "schur_wz_calls": 1}


def bench_ba(dev):
    """LM iterations/s of the CG solve on `dev` against the scipy TRF
    baseline, after the Schur operator's parity gate. Returns (result,
    record): the four keys of the JSON line, and the gate's errors, every
    solve's wall, iterations and matvecs, the baseline and report lines."""
    from sat_bundleadjust_tpu_torch.ba.solver import BASolver
    from sat_bundleadjust_tpu_torch.utils.demo import make_scene_arrays, scene_to_baparams

    # problem scale is env-configurable to cover the BASELINE.json configs
    # (#4: 100+-view robust BA, #5: 1000+-view); defaults = standard problem
    n_cam = int(os.environ.get("SATBA_BENCH_CAMS", 50))
    n_pts = int(os.environ.get("SATBA_BENCH_PTS", 20000))
    obs_per_pt = int(os.environ.get("SATBA_BENCH_OBS", 4))

    scene = make_scene_arrays(n_cam=n_cam, n_pts=n_pts, obs_per_pt=obs_per_pt,
                              rot_scale=2e-5, noise_px=0.1, seed=0, device=dev)
    p = scene_to_baparams(scene, noise_pts=1.0)
    solver = BASolver(p, schur_mode=os.environ.get("SATBA_BENCH_SCHUR", "cg"), device=dev)
    rec = {"n_cam": n_cam, "n_pts": n_pts, "n_obs": n_pts * obs_per_pt, "mode": solver.mode,
           "device": _platform(dev)}

    rec["gate"] = schur_gate(solver)
    _note(rec, "schur_wz parity ({}): vs plain (f64 camera sums) {:.2e}, vs aos {:.2e} of "
               "max|wz|".format(_platform(dev), rec["gate"]["vs_plain"], rec["gate"]["vs_aos"]))

    # warm-up: the first calls into the libraries and the allocator
    *_, info = solver.solve({"max_iter": 2})
    rec["solves"] = [{"warm_up": True, "wall_s": None, "iterations": info["iterations"],
                      "matvecs": info["matvecs"]}]

    # timed full solves: report the median of repeats, with the spread
    samples = []
    for _ in range(5):
        _sync(dev)
        t0 = time.time()
        _, _, err_init, err_ba, info = solver.solve({"max_iter": 30})
        _sync(dev)
        wall = time.time() - t0
        samples.append((wall, info["iterations"]))
        rec["solves"].append({"warm_up": False, "wall_s": wall, "iterations": info["iterations"],
                              "matvecs": info["matvecs"]})
    samples.sort()
    solve_time, iters = samples[len(samples) // 2]
    iters_per_s = iters / solve_time
    _note(rec, "solve wall distribution over {} runs: min {:.2f}s / median {:.2f}s / "
               "max {:.2f}s".format(len(samples), samples[0][0], solve_time, samples[-1][0]))

    # reference-equivalent scipy baseline, at full size up to
    # SATBA_BENCH_BASELINE_MAX_OBS observations; larger configs are measured
    # at 2000 points and scaled linearly in the observation count
    # (conservative: the measured scaling is sublinear in observations at
    # fixed cameras). Both solvers run to the same ftol=1e-4 convergence on
    # statistically identical problems.
    full_baseline = n_pts * obs_per_pt <= int(
        os.environ.get("SATBA_BENCH_BASELINE_MAX_OBS", 100_000))
    base_pts = n_pts if full_baseline else 2000
    base_scene = scene if full_baseline else make_scene_arrays(
        n_cam=n_cam, n_pts=base_pts, obs_per_pt=obs_per_pt, rot_scale=2e-5, noise_px=0.1,
        seed=0, device=dev)
    base_elapsed, base_nfev, base_err = numpy_reference_solver(base_scene, max_nfev=100)
    baseline_full_solve = base_elapsed * (n_pts / base_pts)
    vs_baseline = baseline_full_solve / solve_time
    reproj = float(np.mean(err_ba))
    rec.update({"iterations": iters, "solve_s": solve_time, "lm_it_per_s": iters_per_s,
                "reproj_before": float(np.mean(err_init)), "reproj_after": reproj,
                "baseline": {"pts": base_pts, "elapsed_s": base_elapsed, "nfev": base_nfev,
                             "reproj": base_err, "full_size": full_baseline,
                             "scaled_s": baseline_full_solve}})
    _note(rec, "{}: {:.2f}s full solve ({} iters); scipy baseline: {:.2f}s at {} pts "
               "({} nfev, {:.3f} px){}".format(
                   _platform(dev), solve_time, iters, base_elapsed, base_pts, base_nfev, base_err,
                   " (measured at full size)" if full_baseline
                   else " -> {:.2f}s scaled".format(baseline_full_solve)))

    result = {
        "metric": "ba_lm_iterations_per_second",
        "value": round(iters_per_s, 3),
        "unit": "iter/s ({} cams, {} pts, {} obs, {}; final reproj {:.3f} px)".format(
            n_cam, n_pts, n_pts * obs_per_pt, _platform(dev), reproj),
        "vs_baseline": round(vs_baseline, 2),
    }
    return result, rec


def main():
    dev = bench_device()
    if os.environ.get("SATBA_BENCH_MODE", "ba") == "tracks":
        result, _ = bench_tracks(dev)
    else:
        result, _ = bench_ba(dev)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
