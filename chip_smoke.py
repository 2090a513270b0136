#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sat_bundleadjust_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out record.json]

Needs one NVIDIA GPU and the CUDA toolkit (nvcc); it exits non-zero, with
no result line, where CUDA is not available. It

  1. prints the card, its power limit, the torch/CUDA versions, and asserts
     that TF32 is off;
  2. builds every CUDA kernel of the port from csrc/ (one nvcc per source,
     all at once) and prints the build time and ptxas's registers, spills
     and shared memory of the 2-NN kernels and of the Schur kernels at
     P = 3, 8 and 11;
  3. holds the Schur operator kernel against its plain PyTorch version and
     its "aos" form at the operands of the first LM step of each problem
     below (slices A, B and C), checks that two calls of the function and
     two of the operator bound once (as the CG loop binds it) give the same
     bits, and times it: device time per call from the profiler's spans
     (their count checked), wall time per call of back-to-back calls
     through the bound operator and through the function, and the plain
     version with CUDA events;
  4. slice A: the pipeline's bundle-adjustment stage on the 50-camera demo
     problem (20 000 tracks, 80 000 observations, 2% of them moved by
     10-30 px): C-matrix problem, soft-L1 solve, outlier removal with
     re-triangulation, L2 solve, reconstruct_vars;
  5. slice B: an L2 solve at the 1000-camera time-series scale (200 000
     tracks, 800 000 observations), which must end at a mean reprojection
     error of at most 0.100 px;
  6. solves run their LM iterations as CUDA graphs (ops/lm.build_solve:
     captured at a problem's first solve under a loss, after one eager LM
     iteration where the problem is the first of its kind on the card):
     each solve's host syncs are held to ceil(n / k) + 1 a step of n CG
     iterations (k the CG block: 8 replayed, 1 eager) and its schur_wz
     launches to its matvecs. The L2 solve of each slice (and of slices F
     and J below) runs again replayed (no capture) and then eagerly
     (graphs=False, one CG iteration a block): the same bits of cameras and
     points, the same LM and CG iterations, both walls, LM it/s, host
     syncs, masked CG iterations, capture time and replays; both modes are
     re-run under torch.profiler, which prints the device's busy time per
     LM iteration, its idle share and the kernels that take the device
     time;
  7. solves a 16-camera problem on the CPU (plain operator) and on the
     card (kernel), which must agree;
  8. slice C: the tracks front end at the config #2 scale (10 views of
     2000x2000 px, FT_kp_max 40000, epipolar_based matching, in-memory
     handoff) through FeatureTracksPipeline.build_feature_tracks on frames
     rendered in memory, then its tracks through the bundle-adjustment
     stage (triangulation, soft-L1, outlier removal, L2), which must bring
     the mean reprojection error from above 0.5 px to below 0.3 px;
  9. holds the three 2-NN entry points against their plain versions at the
     operands of slice C's largest kernel chunk, and times them (CUDA
     events; achieved TOP/s and share of the bound, the f32 kernel's time
     before its rounding repair beside it); on fractional descriptors the
     f32 kernel's d1 must lie within 0.5 eps * S of exact distances on
     average and every matched row within 2 x 16 eps * S of its exact
     nearest valid, gated column;
 10. re-runs the detection of two of slice C's frames under torch.profiler
     (device busy time, idle share, top kernels);
 11. the card's SIFT against the CPU's: a 512x512 render and slice C's
     frame 0 detected on both and matched keypoint by keypoint (unmatched
     counts, position, scale and orientation differences, equal
     descriptors; counts within 1%), the 512x512 frame's stages traced on
     both devices from the same input (the first tensor that differs), the
     elementary functions and reductions of the stages on the same seeded
     inputs on both devices (the libraries' and the port's own), and slice
     C's tracks and BA rounds rerun with the CPU's keypoints for frame 0;
     then csrc/sift_blur.cu's blur (r = 13) and 2x upsample at
     rpc_date10.cli's batch (10 frames of 2000x2000 px), held bit for bit
     against their plain versions and timed against their bounds and the
     plain versions, and the pyramid's whole chain of blurs of that batch;
 11a. slice I: the single-image and single-pair entry points on slice C's
     frames: detect_tpu of frame 0 with a mask over the central half, which
     must give slice C's batched detection under that mask bit for bit;
     init_F_pair_to_match of every pair against init_F_pairs_batched (1e-9,
     normalized); match_pair on the card for three pairs, which launches
     the single-pair 2-NN kernel once each (bit-identical to its plain
     version on the pair's operands) and is compared with the staged
     path's matches; 1000 rotations through every conversion, and
     RPCModel's host projection and localization against the card's
     functions for slice C's RPCs;
 12. slice D: the command line interface (`cli.main([config, "--verbose"])`,
     in process) on slice C's ten frames written to disk as .tif with
     their biased RPCs as .rpc files, with the default config plus
     FT_kp_max 40000, FT_save True and save_figures False: scene load,
     footprints, tracks front end, triangulation, soft-L1, outliers, L2,
     the batched RPC refit on the card and the files. It must write 10
     .rpc_adj files whose re-read RPCs take the reprojection error of the
     tracks from above 0.5 px to below 0.3 px; it prints the wall time of
     each stage and the refit's fit error per camera;
 13. slice E: a time series of 3 dates a week apart x 4 views of
     2000x2000 px (RPCs fitted to satellite pinholes 100 km off nadir,
     +-3 px biases, written to disk) through the CLI in ba_sequential and
     then in ba_global (n_dates 1, FT_save True): 12 .rpc_adj files per
     mode, the second and third sequential dates run with the 4 adjusted
     cameras of the date before (n_adj 4), and slice D's reprojection bar
     through the re-read .rpc_adj files for every date; wall per stage;
 14. slice F: the matrix camera models' BA stage: perspective cameras with
     R, T, K and COMMON_K (P = 11) at slice B's scale and affine ones
     (P = 8) at slice A's, each solved on the card with the Schur kernel
     and then with its plain version (mean errors within 1e-3 px, from
     above 1 px to below 0.1 px, the optimized cameras' K equal to 1e-9
     relative), the Schur kernel checked and timed at P = 11 and 8; then
     the CLI with cam_model "perspective" and R, T, K, COMMON_K on slice
     E's first date, which must write P_init/ (asked of the pipeline),
     P_adj/ and .rpc_adj files that hold slice D's bar;
 15. slice G: the CLI on slice E's first date (4 views) with an AOI over
     the central half of the scene (aoi_geojson, FT_kp_aoi) and a DEM
     (dem_path: a UTM GeoTIFF of a tilted plane whose nodes are exact in
     float32): G1 with the opencv detector (FT_n_proc 4) and bruteforce
     matching, so that the int8 2-NN kernel runs with its epipolar gate
     off, G2 with the package's SIFT and epipolar_based matching. Each
     must write 4 .rpc_adj files that hold slice D's bar, keep only
     keypoints inside their masks (each mask 20-80% of its image), and set
     each footprint's altitude to the plane's value at the image's RPC
     centre within 1e-6 m; the int8 kernel is held against its plain
     version at each run's largest chunk. It prints the keypoints per
     image before and after the masks and the wall of every stage;
 16. slice H: the multi-device solve (parallel/), in child processes of
     this script (`--rank`), each phase's ranks killed and the run failed
     when one fails or does not end in time. H1: slice B's problem through
     parallel/dist_solver on one rank with NCCL (H1a) and on two gloo
     ranks sharing the card (H1b): the shard plan, LM and CG iterations,
     all-reduces per CG iteration, wall per LM iteration and the share of
     it in collectives (the device synchronized around each); the ranks'
     cameras bit-identical, schur_wz launches equal to the matvecs on
     every rank, the error within 1e-3 px of slice B's, and shard 0's
     Schur operator held against its plain version. H2: the CLI with
     "distributed": true on slice E's first date on two gloo ranks, one log
     each; each rank detects only its own images, rank 0 alone writes, the
     re-read .rpc_adj go below 0.1 px and project a ground grid within
     1e-2 px of a one-process run's; int8 2-NN launches on both ranks, no
     f32 one;
 17. slice J: the port's bench (sat_bundleadjust_tpu_torch/bench.py) in
     process at its default sizes: ba mode (the Schur parity gate, a
     warm-up and five timed CG solves of bench.py's 50-camera problem, the
     scipy TRF baseline), whose schur_wz launches must equal the six
     solves' matvecs plus the gate's call and whose solve must end at most
     at 0.100 px; tracks mode (6 rendered 300x400 views: SIFT, the 15 pairs
     through the int8 2-NN kernel with its gate off, RANSAC, tracks), which
     must launch nn2_batched_i8 and not nn2_batched and find tracks, and
     whose largest int8 call (all 15 pairs) must give its plain version's
     bits; ba mode's problem on a solver of its own, captured against
     eager (step 6); then `python -m sat_bundleadjust_tpu_torch.bench` as a child
     process at 10 cameras and 2000 points, whose last line must be the
     bench's JSON object; it prints both modes' JSON lines and report
     lines. It runs last, so that slices A-H measure what they did before
     it was added;

and ends with a JSON line per kernel ({"kernels": [...]}) and the result
line {"ok": true, "device": {...}}. Kernel launch counters are set to 0
just before each slice and read just after it: a kernel of the path that
a slice did not launch fails the run, and so does a launch of the f32 2-NN
kernels in slices C, D and J, whose SIFT descriptors must take the int8
kernel; slice I must launch the single-pair kernel once per match_pair.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth; f32 and f64 rates
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12
# dense tensor-core rates: int8 and TF32
PEAK_I8_TC_PER_S = 1979e12
PEAK_TF32_TC_PER_S = 495e12

SOFT_L1 = {"loss": "soft_l1", "f_scale": 1.0, "max_iter": 300}
SLICE_B_MAX_ITER = 30
SLICE_B_MAX_REPROJ = 0.100
# slice C: scripts/run_scale_e2e.py config2 (10 views, 2000x2000 px, terrain
# at the cameras' altitude offset, +-3 px RPC biases, camera 0 the anchor)
SLICE_C = {"views": 10, "h": 2000, "w": 2000, "alt": 50.0, "n_tex": 2048, "tex_octaves": 5,
           "bias_px": 3.0}
SLICE_C_TRACKS_CONFIG = {"FT_kp_max": 40000, "FT_sift_matching": "epipolar_based",
                         "FT_save": False, "FT_reset": True}
SLICE_C_REPROJ_BEFORE_MIN = 0.5
SLICE_C_REPROJ_AFTER_MAX = 0.3
# slice D: the CLI's defaults plus these keys, on slice C's frames
SLICE_D_CONFIG = {"rpc_src": "txt", "FT_kp_max": 40000, "FT_save": True, "save_figures": False}
# slice E: a time series of 3 dates a week apart x 4 views of 2000x2000 px,
# rendered by slice C's renderer through RPCs fitted to satellite pinholes
# 100 km off nadir (3 m/px), +-3 px RPC biases (camera 0 of date 0 the
# anchor); the CLI in ba_sequential and then ba_global, n_dates 1
SLICE_E = {"dates": 3, "views": 4, "h": 2000, "w": 2000, "alt": 50.0, "n_tex": 2048,
           "tex_octaves": 5, "bias_px": 3.0, "gsd": 3.0, "off_nadir_m": 1e5}
SLICE_E_CONFIG = dict(SLICE_D_CONFIG, n_dates=1)
# slice F: the matrix camera models' BA stage: perspective R, T, K with
# COMMON_K (P = 11) at slice B's scale, affine R, T, K (P = 8) at slice A's
SLICE_F_PERSPECTIVE = {"n_cam": 1000, "n_pts": 200000, "obs_per_pt": 4}
SLICE_F_AFFINE = {"n_cam": 50, "n_pts": 20000, "obs_per_pt": 4}
SLICE_F_PARAMS = ["R", "T", "K", "COMMON_K"]
SLICE_F_MAX_ITER = 30
SLICE_F_REPROJ_BEFORE_MIN = 1.0
SLICE_F_REPROJ_AFTER_MAX = 0.1
# slice G: the CLI on slice E's first date (4 views of 2000x2000 px; slice D
# has 10, cut to 4 for the run's time) with an AOI over the central half of
# the scene (FT_kp_aoi) and a UTM DEM of the plane z = a + b * column + c *
# row of its raster (res m a node, +-half m around the AOI's centre; every
# node exact in float32); G1 the opencv detector with bruteforce matching
# (the int8 2-NN kernel with its gate off), G2 the package's SIFT with
# epipolar_based matching
SLICE_G_DEM = {"res": 32.0, "half": 8000.0, "plane": (50.0, 1.0 / 64, -1.0 / 128)}
SLICE_G_RUNS = {
    "G1": dict(SLICE_D_CONFIG, FT_kp_aoi=True, FT_sift_detection="opencv",
               FT_sift_matching="bruteforce", FT_n_proc=4),
    "G2": dict(SLICE_D_CONFIG, FT_kp_aoi=True),
}
SLICE_G_MASK_SHARE = (0.2, 0.8)
# slice H: the distributed solve (slice B's problem) within 1e-3 px of slice
# B's one-device error; the CLI across two ranks on slice E's first date
# below 0.1 px through its .rpc_adj, which project a ground grid within
# 1e-2 px of the one-process run's; each phase's ranks must end in time
SLICE_H_BAR_PX = 1e-3
SLICE_H2_REPROJ_AFTER_MAX = 0.1
SLICE_H2_GRID_PX = 1e-2
SLICE_H_TIMEOUT_S = 300
SLICE_G_ALT_TOL_M = 1e-6
# slice I: the single-pair matcher on the first pairs of slice C
SLICE_I_PAIRS = 3
# slice J: the port's bench in process at its default sizes (bench.py's
# 50-camera problem; 6 rendered 300x400 views), which must end at JAX's
# 0.098 px (BENCH_r05.json) plus f32 CG's margin; then the module as a
# child process at a small size
SLICE_J_DEFAULTS = {"n_cam": 50, "n_pts": 20000, "n_obs": 80000, "images": 6, "h": 300, "w": 400}
SLICE_J_MAX_REPROJ = 0.100
SLICE_J_MODULE_ENV = {"SATBA_BENCH_CAMS": "10", "SATBA_BENCH_PTS": "2000"}
SLICE_J_TIMEOUT_S = 300
# the f32 2-NN kernel's times at slice C's chunk before its rounding repair
# (PR 10's chip run 2, H100 80GB HBM3, 700 W)
NN2_F32_BEFORE_MS = {"nn2_batched": 20.8669, "nn2_single": 0.5224}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
# csrc/sift_blur.cu's check: rpc_date10.cli's one batch, 10 frames of
# 2000x2000 px (the first octave 10 x 4000 x 4000)
SIFT_BLUR_BATCH = (10, 2000, 2000)
# csrc/rpc_triangulate.cu's check: rpc_ba1000_clean.robust's outlier pass,
# ~1.13 M duos between 1 000 cameras (the ring's linear RPCs, 300 px of
# parallax, dealt with stride 381 as portbench/scenes/orbit.py deals them)
RPC_TRIANGULATE_SHAPE = {"cameras": 1000, "duos": 1_130_000, "stride": 381}


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


def profile_schur(label, op, x, reps, warm=3, tries=3, pause_s=0.2, spare=32):
    """Device time per call of a bound Schur operator from the profiler's
    kernel spans (by kernel name): `warm` calls and a pause, then `spare`
    calls and `reps` timed ones. The profiler's device tracing can miss the
    first calls of a window (2 spans of 406 in most runs on the H100, 279
    of 406 in one) and the first calls after the pause (4 spans in most
    windows, the spans of 11 calls in every window of one shape in one run;
    `spare` untimed calls follow the pause), so only the spans after the
    pause (the last gap
    of at least half of it between two spans on the device's clock) are
    read, the last reps * kernels of them are the timed calls', and each
    kernel of KERNEL_NAMES must show exactly `reps` spans among those: a
    renamed kernel cannot read as 0. A window that missed spans is taken
    again, up to `tries` windows. Returns (ms per call, the union of the
    kernels' spans; {kernel: ms per call}; spans seen)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv

    assert op.kernels_per_call == len(smv.KERNEL_NAMES), (label, op.kernels_per_call)
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(warm):
                op(x)
            torch.cuda.synchronize()
            time.sleep(pause_s)
            for _ in range(spare + reps):
                op(x)
            torch.cuda.synchronize()
        _, _, kern = device_busy(label, prof)
        ours = sorted((e for e in kern if any(n in e.name for n in smv.KERNEL_NAMES)),
                      key=lambda e: e.time_range.start)
        first, end = 0, float("inf")
        for i, e in enumerate(ours):
            if e.time_range.start - end >= pause_s * 0.5e6:
                first = i
            end = e.time_range.end if i == 0 else max(end, e.time_range.end)
        ours = ours[first:][-reps * len(smv.KERNEL_NAMES):]
        seen = {n: sum(n in e.name for e in ours) for n in smv.KERNEL_NAMES}
        if all(c == reps for c in seen.values()):
            break
        log("{}: window {} saw {} spans of the {} timed calls; taken again".format(
            label, attempt + 1, seen, reps))
    else:
        raise AssertionError((label, seen, reps))
    split, spans = {}, {}
    for n in smv.KERNEL_NAMES:
        mine = [e for e in ours if n in e.name]
        spans[n] = len(mine)
        span_us = sum(e.time_range.end - e.time_range.start for e in mine)
        split[n] = span_us / max(len(mine), 1) / 1e3
    # a dependent launch's span starts before its predecessor ends: per
    # call, the union of the spans
    busy_us, end = 0.0, float("-inf")
    for e in ours:
        busy_us += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
    return busy_us / len(ours) * op.kernels_per_call / 1e3, split, spans


def check_schur_wz(tag, p, solver):
    """Kernel vs plain version vs aos form, repeatability, times, bound.

    The operator the CG loop binds once per LM step (SchurOperator) and the
    function (bind, then call) must give the same bits. Times per call:
    device_ms, the union of the profiler spans of the bound operator's
    kernels (and their mean span by kernel name); op_wall_ms and wall_ms,
    back-to-back calls of the bound operator and of the function between
    CUDA events (which measure the host where it enqueues more slowly than
    the device runs)."""
    import torch

    from sat_bundleadjust_tpu_torch.bench import GATE_AOS, GATE_PLAIN, schur_operands
    from sat_bundleadjust_tpu_torch.ops import lm
    from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv

    args = schur_operands(solver)
    W_pt, cam_ind_pt, W_cm, pts_ind_cam = args
    M, P = p.n_cam, p.n_params
    x = torch.randn(M, P, dtype=torch.float32, device=solver.device,
                    generator=torch.Generator(solver.device).manual_seed(0))
    op = smv.SchurOperator(*args)
    wz1 = smv.schur_wz(x, *args)
    wz2 = smv.schur_wz(x, *args)
    wz_op = op(x).clone()
    plain = smv.schur_wz_plain(x, *args)
    aos = lm.schur_wz_aos(x, *args)
    torch.cuda.synchronize()
    scale = float(plain.abs().max())
    err_plain = float((wz1 - plain).abs().max())
    err_aos = float((wz1 - aos).abs().max())
    same_bits = all(bool(torch.equal(w, wz1)) for w in (wz2, wz_op, op(x)))
    assert bool(torch.isfinite(wz1).all()), "schur_wz: non-finite output"
    assert err_plain <= GATE_PLAIN * scale, (tag, err_plain / scale)
    assert err_aos <= GATE_AOS * scale, (tag, err_aos / scale)
    assert same_bits, "schur_wz: two calls, or the bound operator and the function, differ"

    K = p.n_obs
    reps = 200 if K < 200_000 else 50
    wall_ms = cuda_ms(lambda: smv.schur_wz(x, *args), reps)
    op_wall_ms = cuda_ms(lambda: op(x), reps)
    device_ms, split, spans = profile_schur("schur_wz " + tag, op, x, reps)
    plain_ms = cuda_ms(lambda: smv.schur_wz_plain(x, *args), max(reps // 10, 5))
    # a yardstick, not a kernel of the port: PyTorch copying both What
    # layouts (each byte read once and written once), the rate this card
    # reaches on plain streams
    copies = (torch.empty_like(W_pt), torch.empty_like(W_cm))
    copy_ms = cuda_ms(lambda: (copies[0].copy_(W_pt), copies[1].copy_(W_cm)), reps)
    copy_rate = 2 * 4 * (W_pt.numel() + W_cm.numel()) / copy_ms / 1e9
    # least work: x, both What layouts at the K real observations, both
    # index tables, wz; K*P*3 f32 FMAs (track side) and K*P*3 f64 FMAs
    # (camera side)
    nbytes = 4 * (2 * M * P + 2 * K * P * 3 + cam_ind_pt.numel() + pts_ind_cam.numel())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (2 * K * P * 3 / PEAK_F32_PER_S + 2 * K * P * 3 / PEAK_F64_PER_S) * 1e3
    rec = {
        "shape": {"M": M, "N": p.n_pts, "K": K, "P": P, "Tp": int(cam_ind_pt.shape[1]),
                  "Tc": int(pts_ind_cam.shape[1])},
        "geometry": op.geometry, "kernels_per_call": op.kernels_per_call,
        "max_abs_err": err_plain, "rel_err_plain": err_plain / scale,
        "rel_err_aos": err_aos / scale, "bit_identical": same_bits,
        "device_ms": device_ms, "split_ms": split, "spans": spans, "op_wall_ms": op_wall_ms,
        "wall_ms": wall_ms, "plain_ms": plain_ms, "torch_copy_ms": copy_ms,
        "torch_copy_tb_per_s": copy_rate,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes,
    }
    log("schur_wz [{}] M={M} N={N} K={K} P={P} Tp={Tp} Tc={Tc}: geometry {}; vs plain {:.2e}, "
        "vs aos {:.2e} of max|wz|, bit-identical {}; device {:.5f} ms per call "
        "({} kernels, spans {}: {}), wall {:.5f} ms bound operator / {:.5f} ms function "
        "({} calls), plain {:.4f} ms, bound {:.5f} ms ({:.1f} MB); torch copies both layouts "
        "in {:.5f} ms ({:.2f} TB/s read + write)".format(
            tag, op.geometry, rec["rel_err_plain"], rec["rel_err_aos"], same_bits,
            device_ms, op.kernels_per_call, spans,
            ", ".join("{} {:.5f}".format(k, v) for k, v in split.items()), op_wall_ms, wall_ms,
            reps, plain_ms, rec["bound_ms"], nbytes / 1e6, copy_ms, copy_rate, **rec["shape"]))
    return rec


def solve_round(solver, ls, label, graphs=True):
    """One solve of `solver` (its LM iterations as CUDA graphs, or eagerly
    with graphs=False), timed; its counters, and the host reads checked
    against ceil(n / k) + 1 for each LM step of n CG iterations (k the CG
    block)."""
    import numpy as np
    import torch

    from sat_bundleadjust_tpu_torch.ops import lm
    from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv

    torch.cuda.synchronize()
    launches0 = smv.schur_wz.launches
    t0 = time.time()
    _, (cam, pts), e0, e1, info = solver.solve(ls, graphs=graphs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = smv.schur_wz.launches - launches0
    k = lm.cg_block(solver.config(ls).cg_iters or lm.default_cg_iters(solver.p.n_cam), graphs)
    bound = sum(-(-n // k) + 1 for n in info["cg_steps"])
    rec = {
        "iterations": info["iterations"], "wall_s": wall,
        "lm_it_per_s": info["iterations"] / wall,
        "reproj_before_mean": float(np.mean(e0)), "reproj_before_median": float(np.median(e0)),
        "reproj_after_mean": float(np.mean(e1)), "reproj_after_median": float(np.median(e1)),
        "host_syncs": info["host_syncs"], "cg_iterations": info["cg_iterations"],
        "cg_masked": info["cg_masked"], "cg_steps": info["cg_steps"], "cg_block": k,
        "host_sync_bound": bound, "matvecs": info["matvecs"],
        "graph_replays": info["graph_replays"], "capture_s": info["capture_s"],
        "graphs": graphs, "kernel_launches": launches, "mode": solver.mode,
    }
    assert np.all(np.isfinite(e1)) and e1.shape == (solver.p.n_obs,)
    assert launches == info["matvecs"] > 0, (label, launches, info["matvecs"])
    assert info["host_syncs"] <= bound, (label, info["host_syncs"], bound)
    assert (info["graph_replays"] > 0) == graphs, (label, info["graph_replays"])
    log("{} ({}): {} LM iterations in {:.3f} s ({:.2f} it/s); reprojection mean/median "
        "{:.4f}/{:.4f} -> {:.4f}/{:.4f} px; {} host syncs (bound {}), {} CG iterations "
        "(k = {}; per LM step {}), {} masked, {} matvecs, {} schur_wz launches, {} graph "
        "replays, capture {:.3f} s".format(
            label, "graphs" if graphs else "eager", rec["iterations"], wall, rec["lm_it_per_s"],
            rec["reproj_before_mean"], rec["reproj_before_median"], rec["reproj_after_mean"],
            rec["reproj_after_median"], rec["host_syncs"], bound, rec["cg_iterations"], k,
            info["cg_steps"], rec["cg_masked"], rec["matvecs"], launches,
            rec["graph_replays"], rec["capture_s"]))
    return cam, pts, e1, rec


def graphs_against_eager(label, solver, ls, main, profile_ls=None):
    """After the main path's solve `main` = (cam, pts, record), which
    captured the solver's graphs: the same solve replayed (no capture), then
    run eagerly (graphs=False, the same phases without graphs). The three
    must give the same bits of cam and pts; the replayed and the eager solve
    are profiled (profile_ls: a shorter solve where given), each against its
    own wall per LM iteration."""
    import torch

    cam, pts, first = main
    cam_r, pts_r, _, replay = solve_round(solver, ls, label + ", again")
    cam_e, pts_e, _, eager = solve_round(solver, ls, label, graphs=False)
    same = all(bool(torch.equal(a, b)) for a, b in ((cam, cam_e), (pts, pts_e), (cam_r, cam_e),
                                                     (pts_r, pts_e)))
    log("{}: graphs against eager: walls {:.4f} s (first, capture {:.3f} s of it) / {:.4f} s "
        "(again) / {:.4f} s (eager), LM it/s {:.2f} / {:.2f}; host syncs {} / {}; cam and pts "
        "bit-identical {}".format(label, first["wall_s"], first["capture_s"], replay["wall_s"],
                                  eager["wall_s"], replay["lm_it_per_s"], eager["lm_it_per_s"],
                                  replay["host_syncs"], eager["host_syncs"], same))
    assert same, label + ": the captured solve's bits differ from the eager solve's"
    assert first["capture_s"] > 0 and replay["capture_s"] == 0, (first, replay)
    for key in ("iterations", "cg_steps", "cg_iterations"):
        assert first[key] == replay[key] == eager[key], (label, key, replay[key], eager[key])
    prof_ls = ls if profile_ls is None else profile_ls
    prof = {mode: profile_window("{} {}".format(label, mode), solver, prof_ls,
                                 r["wall_s"] / r["iterations"], graphs=mode == "graphs")
            for mode, r in (("graphs", replay), ("eager", eager))}
    return {"first": first, "again": replay, "eager": eager, "bit_identical": same,
            "profile": prof}


def device_busy(label, prof):
    """Device busy time of a torch.profiler window (the union of the
    kernels' spans, us), kernel time by name, and the kernel events."""
    import torch

    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kern, "{}: the profiler saw no device activity".format(label)
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for e in sorted(kern, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    return busy_us, by_name, kern


def profile_window(label, solver, ls, wall_per_it, graphs=True):
    """Re-run a solve under torch.profiler: device busy time (the union of
    the kernels' spans), kernels per LM iteration, the operator kernels'
    share of device time, and the device's idle share against wall_per_it,
    the unprofiled wall time per LM iteration of the same solve."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        *_, info = solver.solve(ls, graphs=graphs)
        torch.cuda.synchronize()
    busy_us, by_name, kern = device_busy(label, prof)
    total_us = sum(by_name.values())
    schur_us = sum(v for k, v in by_name.items() if any(n in k for n in smv.KERNEL_NAMES))
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
    p2 = outliers.rm_outliers(e_soft, p, device=dev)
    torch.cuda.synchronize()
    rm_s = time.time() - t0
    # the count, outside the timing
    cam_ind = torch.as_tensor(p.cam_ind).long()
    thr = outliers.camera_thresholds(torch.as_tensor(e_soft), cam_ind, p.n_cam)
    n_flagged = int((torch.as_tensor(e_soft).double() > thr[cam_ind]).sum())
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
    graphs = graphs_against_eager("slice A L2", solver2, None, (cam, pts, l2))
    return {"profile": graphs["profile"]["graphs"], "graphs": graphs, "soft_l1": soft, "l2": l2,
            "flagged": n_flagged, "removed": p.n_obs - p2.n_obs,
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
    ls = {"max_iter": SLICE_B_MAX_ITER}
    cam, pts, _, l2 = solve_round(solver, ls, "slice B L2")
    launches = {k.__name__: k.launches for k in kernels["counters"]}
    assert all(n > 0 for n in launches.values()), launches
    assert l2["reproj_after_mean"] <= SLICE_B_MAX_REPROJ, l2["reproj_after_mean"]
    log("slice B: max_iter {} (not cut); kernel launches {}".format(SLICE_B_MAX_ITER, launches))
    graphs = graphs_against_eager("slice B L2", solver, ls, (cam, pts, l2),
                                  profile_ls={"max_iter": 5})
    return {"profile": graphs["profile"]["graphs"], "graphs": graphs, "l2": l2,
            "launches": launches}


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


def slice_j(dev, counters):
    """The port's bench (sat_bundleadjust_tpu_torch/bench.py): its ba and
    tracks modes in process at their default sizes, the counters set to 0
    before each and read after it, the int8 2-NN kernel held to its plain
    version at the largest call tracks mode made of it, then `python -m
    sat_bundleadjust_tpu_torch.bench` once as a child process at a small
    size, whose last stdout line must be the bench's JSON object."""
    import torch

    from sat_bundleadjust_tpu_torch import bench
    from sat_bundleadjust_tpu_torch.ops import nn2_match as nm

    out, largest_call = {}, {}
    for mode, run in (("ba", bench.bench_ba), ("tracks", bench.bench_tracks)):
        for k in counters:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        with LargestI8Call() as largest:
            result, rec = run(dev)
        torch.cuda.synchronize()
        rec["wall_s"] = time.time() - t0
        rec["launches"] = {k.__name__: k.launches for k in counters}
        largest_call[mode] = largest.args
        for line in rec["log"]:
            log("slice J {}: {}".format(mode, line))
        log("slice J {} JSON: {}".format(mode, json.dumps(result)))
        log("slice J {}: {:.2f} s in all; kernel launches {}".format(mode, rec["wall_s"],
                                                                      rec["launches"]))
        assert set(result) == BENCH_KEYS and result["value"] > 0, result
        out[mode] = dict(rec, result=result)

    ba, tr = out["ba"], out["tracks"]
    assert (ba["n_cam"], ba["n_pts"], ba["n_obs"], tr["images"], tr["h"], tr["w"]) == tuple(
        SLICE_J_DEFAULTS.values()), "slice J runs the bench at its default sizes"
    matvecs = sum(s["matvecs"] for s in ba["solves"])
    ba["main_path_schur_wz"] = matvecs
    assert ba["launches"]["schur_wz"] == matvecs + ba["gate"]["schur_wz_calls"] > 0, (
        ba["launches"], matvecs)
    assert ba["reproj_after"] <= SLICE_J_MAX_REPROJ, ba["reproj_after"]
    assert tr["launches"]["nn2_batched_i8"] >= 1 and tr["launches"]["nn2_batched"] == 0, (
        tr["launches"])
    assert tr["tracks"] > 0, tr["tracks"]

    # after the counters were read: the int8 kernel against its plain
    # version at the largest chunk tracks mode gave it
    args = largest_call["tracks"]
    a = nm.nn2_batched_i8(*args)
    plain = nm.nn2_plain(*args)
    torch.cuda.synchronize()
    gate = "off" if bool((args[6] >= 1e9).all()) else "on"
    B, n1, n2 = args[0].shape[0], args[0].shape[1], args[1].shape[1]
    ms = cuda_ms(lambda: nm.nn2_batched_i8(*args), 20)
    plain_ms = cuda_ms(lambda: nm.nn2_plain(*args), 1, rounds=3)
    bound_ms, bound_by, ops, _ = nn2_bound(args[4], args[5], 128, PEAK_I8_TC_PER_S)
    log("slice J tracks: int8 2-NN at the largest chunk (gate {}, B={} n1={} n2={}): {}; kernel "
        "{:.4f} ms ({:.1f} TOP/s, {:.1%} of the bound), plain {:.4f} ms, bound {:.4f} ms "
        "({})".format(gate, B, n1, n2, "bit-identical to plain" if torch.equal(a, plain)
                      else "DIFFERS from plain", ms, ops / ms / 1e9, bound_ms / ms, plain_ms,
                      bound_ms, bound_by))
    assert torch.equal(a, plain), "nn2_batched_i8 differs from its plain version"
    assert gate == "off" and B == len(tr["keypoints"]) * (len(tr["keypoints"]) - 1) // 2, (gate, B)
    tr["i8_largest_chunk"] = {"gate": gate, "B": B, "n1": n1, "n2": n2, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}

    # the bench's ba problem on a solver of its own: the captured solve, then
    # the eager one
    from sat_bundleadjust_tpu_torch.ba.solver import BASolver
    from sat_bundleadjust_tpu_torch.utils.demo import make_scene_arrays, scene_to_baparams

    n_cam, n_pts, n_obs = (SLICE_J_DEFAULTS[k] for k in ("n_cam", "n_pts", "n_obs"))
    scene = make_scene_arrays(n_cam=n_cam, n_pts=n_pts, obs_per_pt=n_obs // n_pts,
                              rot_scale=2e-5, noise_px=0.1, seed=0, device=dev)
    solver = BASolver(scene_to_baparams(scene, noise_pts=1.0), schur_mode="cg", device=dev)
    ls = {"max_iter": 30}
    cam, pts, _, first = solve_round(solver, ls, "slice J ba")
    ba["graphs"] = graphs_against_eager("slice J ba", solver, ls, (cam, pts, first))

    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("SATBA_BENCH_")}
    env.update(SLICE_J_MODULE_ENV)
    t0 = time.time()
    child = subprocess.run([sys.executable, "-m", "sat_bundleadjust_tpu_torch.bench"], cwd=repo,
                           env=env, capture_output=True, text=True, timeout=SLICE_J_TIMEOUT_S)
    wall = time.time() - t0
    for line in child.stderr.strip().splitlines()[-6:]:
        log("slice J module: " + line[:300])
    assert child.returncode == 0, child.stderr[-4000:]
    result = json.loads(child.stdout.strip().splitlines()[-1])
    assert set(result) == BENCH_KEYS, result
    log("slice J module ({}) in {:.2f} s, last line: {}".format(
        " ".join("{}={}".format(*kv) for kv in SLICE_J_MODULE_ENV.items()), wall,
        json.dumps(result)))
    out["module"] = {"env": SLICE_J_MODULE_ENV, "wall_s": wall, "result": result}
    return out


def render_scene_c(dev):
    """Slice C's views, rendered in memory: uint8 frames of a 2048^2 texture
    of 5 noise octaves through synthetic RPCs, and SatelliteImages whose
    RPCs carry per-camera biases of up to +-3 px (camera 0 unbiased), with
    footprints at the terrain altitude and camera centers set."""
    import numpy as np

    from sat_bundleadjust_tpu_torch.models.cameras import SatelliteImage
    from sat_bundleadjust_tpu_torch.utils import demo

    c = SLICE_C
    ims, rpcs = demo.render_synthetic_images(
        n_cam=c["views"], h=c["h"], w=c["w"], seed=0, alt=c["alt"], n_tex=c["n_tex"],
        tex_octaves=c["tex_octaves"], device=dev)
    rng = np.random.RandomState(1)
    images = []
    for k, (im, rpc) in enumerate(zip(ims, rpcs)):
        bias = np.zeros(2) if k == 0 else rng.uniform(-c["bias_px"], c["bias_px"], 2)
        rpc = rpc._replace(col_offset=rpc.col_offset + bias[0],
                           row_offset=rpc.row_offset + bias[1])
        frame = (im * 255).astype(np.uint8)
        si = SatelliteImage(frame, rpc, offset={"col0": 0, "row0": 0, "height": c["h"],
                                                "width": c["w"]})
        si.set_footprint(alt=c["alt"])
        si.set_camera_center()
        images.append(si)
    return images


def slice_c(dev, counters):
    """The tracks front end at the config #2 scale, and its tracks through
    the bundle-adjustment stage."""
    import tempfile

    import numpy as np
    import torch

    from sat_bundleadjust_tpu_torch.ba.solver import BASolver
    from sat_bundleadjust_tpu_torch.tracks.pipeline import FeatureTracksPipeline

    t0 = time.time()
    images = render_scene_c(dev)
    render_s = time.time() - t0
    log("slice C: {} views of {}x{} px rendered in memory in {:.2f} s; route: "
        "FeatureTracksPipeline.build_feature_tracks on the in-memory frames".format(
            len(images), SLICE_C["h"], SLICE_C["w"], render_s))

    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    t_path = time.time()
    with tempfile.TemporaryDirectory(prefix="slice_c_") as out_dir:
        ft = FeatureTracksPipeline(out_dir, out_dir, {"images": images, "n_adj": 0, "aoi": None},
                                   tracks_config=dict(SLICE_C_TRACKS_CONFIG), device=dev)
        bundle, tracks_total_s = ft.build_feature_tracks()
    kp = [int(np.sum(~np.isnan(f[:, 0]))) for f in bundle["features"]]
    C = bundle["C"]
    assert C is not None and C.shape[0] == 2 * len(images) and C.shape[1] > 1000, (
        None if C is None else C.shape)
    timing = dict(ft.timing)

    p, p2, soft, l2 = tracks_ba(bundle, images, dev, "slice C")
    torch.cuda.synchronize()
    path_s = time.time() - t_path
    launches = {k.__name__: k.launches for k in counters}
    # after the counters are read: these launches are comparisons
    schur = check_schur_wz("slice C", p, BASolver(p, device=dev))

    log("slice C tracks: keypoints per frame {}; {} pairs to match, {} pairwise matches, "
        "{} tracks ({} observations)".format(kp, len(bundle["pairs_to_match"]),
                                             bundle["pairwise_matches"].shape[0], C.shape[1],
                                             int(np.sum(~np.isnan(C[::2])))))
    stages = [("detection", "detection_s"), ("pairs", "pairs_s"), ("F init", "F_init_s"),
              ("staging", "stage_s"), ("device 2-NN", "nn_s"),
              ("  of which enqueue", "nn_enqueue_s"), ("  of which drain", "nn_drain_s"),
              ("RANSAC/UTM finalize", "finalize_s"), ("  of which RANSAC", "ransac_s"),
              ("  of which UTM", "utm_s"), ("tracks", "tracks_s")]
    log("slice C stage times: " + "; ".join(
        "{} {:.3f} s".format(name, timing.get(key, float("nan"))) for name, key in stages)
        + "; tracks front end {:.3f} s".format(tracks_total_s))
    log("slice C BA: {} obs, {} tracks; soft-L1 {:.4f} -> {:.4f} px; outliers removed {}; "
        "L2 -> {:.4f} px (mean); kernel launches {}".format(
            p.n_obs, p.n_pts, soft["reproj_before_mean"], soft["reproj_after_mean"],
            p.n_obs - p2.n_obs, l2["reproj_after_mean"], launches))
    assert launches["nn2_batched_i8"] > 0, launches
    assert launches["nn2_batched"] == 0 and launches["nn2_single"] == 0, launches
    assert launches["schur_wz"] == soft["matvecs"] + l2["matvecs"] > 0, launches
    assert launches["blur"] > 0 and launches["upsample2"] > 0, launches
    assert soft["reproj_before_mean"] > SLICE_C_REPROJ_BEFORE_MIN, soft["reproj_before_mean"]
    assert l2["reproj_after_mean"] < SLICE_C_REPROJ_AFTER_MAX, l2["reproj_after_mean"]
    return {"render_s": render_s, "keypoints": kp, "pairs": len(bundle["pairs_to_match"]),
            "pairwise_matches": int(bundle["pairwise_matches"].shape[0]),
            "tracks": int(C.shape[1]), "timing": timing, "tracks_total_s": tracks_total_s,
            "path_s": path_s, "soft_l1": soft, "l2": l2, "removed": p.n_obs - p2.n_obs,
            "launches": launches, "schur_wz": schur, "ft": ft, "images": images}


def profile_detection(images, dev, n=2):
    """Detection of n of slice C's frames: unprofiled wall (warm), then the
    same call under torch.profiler for the device's busy time, its idle
    share against the unprofiled wall, and the kernels that take it."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sat_bundleadjust_tpu_torch.ops import sift

    frames = [np.asarray(im.geotiff_path, np.float32) for im in images[:n]]
    kw = {"max_kp": SLICE_C_TRACKS_CONFIG["FT_kp_max"], "device": dev}
    sift.detect_sift_batch(frames, **kw)
    torch.cuda.synchronize()
    t0 = time.time()
    sift.detect_sift_batch(frames, **kw)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sift.detect_sift_batch(frames, **kw)
        torch.cuda.synchronize()
    busy_us, by_name, kern = device_busy("detection", prof)
    total_us = sum(by_name.values())
    rec = {"frames": n, "wall_s": wall_s, "device_busy_s": busy_us / 1e6,
           "idle_share": 1.0 - busy_us / 1e6 / wall_s, "kernels": len(kern),
           "top": sorted(((v / total_us, k[:60]) for k, v in by_name.items()), reverse=True)[:8]}
    log("profile [detection, {} frames of slice C]: {:.3f} s of wall, device busy {:.3f} s "
        "(idle share {:.1%}); {} device kernels; top: {}".format(
            n, wall_s, rec["device_busy_s"], rec["idle_share"], len(kern),
            "; ".join("{:.1%} {}".format(*x) for x in rec["top"])))
    return rec


def largest_staged_chunk(ft, images, dev):
    """The int8 kernel's operands of slice C's largest chunk, rebuilt as
    match_stereo_pairs builds them (UTM boxes, staged frames, chunks)."""
    from sat_bundleadjust_tpu_torch.ops import match as match_ops
    from sat_bundleadjust_tpu_torch.tracks import matching
    from sat_bundleadjust_tpu_torch.utils.geo import geojson_to_polygon

    F = matching.init_F_pairs_batched(ft.pairs_to_match, images)
    pair_frames, pair_idx, pair_F = [], [], []
    for q, (i, j) in enumerate(ft.pairs_to_match):
        poly = geojson_to_polygon(ft.footprints[i]["geojson"]).intersection(
            geojson_to_polygon(ft.footprints[j]["geojson"]))
        if poly.coords.shape[0] < 3:
            continue
        idx_i, idx_j = matching.utm_bbox_indices(ft.features_utm[i], ft.features_utm[j], poly)
        if len(idx_i) and len(idx_j):
            pair_frames.append((i, j))
            pair_idx.append((idx_i, idx_j))
            pair_F.append(F[q])
    staged = match_ops.stage_frames_for_matching(ft.features, device=dev)
    chunks = list(match_ops.staged_chunks(pair_idx))
    chunk, n1, n2 = max(chunks, key=lambda c: len(c[0]) * c[1] * c[2])
    arrays = match_ops.staged_chunk_arrays(chunk, n1, n2, pair_frames, pair_idx, pair_F,
                                           match_ops.EPIPOLAR_THR)
    return match_ops.staged_chunk_operands(staged, arrays), len(chunks)


def nn2_bound(mi, mj, desc_bytes, peak_ops):
    """Least time of a 2-NN call: the cross term's operations on the valid
    rows and columns of each pair at the tensor-core rate, against each
    input read once and the packed output written once."""
    n1 = mi.sum(dim=1).double()
    n2 = mj.sum(dim=1).double()
    ops = float((2.0 * 128 * n1 * n2).sum())
    # descriptor, line or point (12 B) and validity (4 B) per row; thr; output
    nbytes = float(((n1 + n2) * (desc_bytes + 12 + 4)).sum() + 4 * mi.shape[0] + 12 * n1.sum())
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def excess_over_exact_minimum(res, d_i, d_j, li, hj, vi, vj, thr):
    """The largest, over the rows with a match, of the exact distance
    (float64, from the float32 descriptors) to the column in idx minus the
    exact minimum over the row's valid columns that pass the gate (the plain
    version's float32 gate, in its order), pair by pair; and the rows."""
    import torch

    from sat_bundleadjust_tpu_torch.ops import nn2_match as nm

    worst, rows = 0.0, 0
    for b in range(d_i.shape[0]):
        di, dj = d_i[b].double(), d_j[b].double()
        exact = (di * di).sum(1)[:, None] + (dj * dj).sum(1)[None, :] - 2.0 * (di @ dj.T)
        l, h = li[b], hj[b]
        num = (l[:, 0:1] * h[None, :, 0] + l[:, 1:2] * h[None, :, 1]) + l[:, 2:3] * h[None, :, 2]
        denom = l[:, 0:1] * l[:, 0:1] + l[:, 1:2] * l[:, 1:2]
        ok = (num * num <= (thr[b] * thr[b]) * denom) & (vi[b][:, None] > 0) & (vj[b][None, :] > 0)
        best = torch.where(ok, exact, torch.full_like(exact, float("inf"))).min(1).values
        at = exact.gather(1, res[b, 2].long()[:, None])[:, 0]
        ex = (at - best)[res[b, 0] < nm.BIG]
        if ex.numel():
            worst = max(worst, float(ex.max()))
            rows += ex.numel()
        del exact, num, ok
    return worst, rows


def check_nn2(ft, images, dev):
    """The three 2-NN entry points against their plain versions at the
    operands of slice C's largest staged chunk."""
    import torch

    from sat_bundleadjust_tpu_torch.ops import nn2_match as nm

    (di, dj, li, hj, mi, mj, thr), n_chunks = largest_staged_chunk(ft, images, dev)
    B, n1, n2 = di.shape[0], di.shape[1], dj.shape[1]
    a = nm.nn2_batched_i8(di, dj, li, hj, mi, mj, thr)
    b = nm.nn2_batched_i8(di, dj, li, hj, mi, mj, thr)
    plain = nm.nn2_plain(di, dj, li, hj, mi, mj, thr)
    dif = (di.float() + 128.0).contiguous()
    djf = (dj.float() + 128.0).contiguous()
    f = nm.nn2_batched(dif, djf, li, hj, mi, mj, thr)
    g = torch.Generator(dev).manual_seed(3)
    din = (dif + torch.rand(dif.shape, generator=g, device=dev)).contiguous()
    djn = (djf + torch.rand(djf.shape, generator=g, device=dev)).contiguous()
    fn = nm.nn2_batched(din, djn, li, hj, mi, mj, thr)
    fn_plain = nm.nn2_plain(din, djn, li, hj, mi, mj, thr)
    thr0 = float(thr[0])  # read once: a read from the card inside a timed call would sync it
    s = nm.nn2_single(dif[0], djf[0], li[0], hj[0], mi[0], mj[0], thr0)
    s_plain = nm.nn2_plain(dif[:1], djf[:1], li[:1], hj[:1], mi[:1], mj[:1], thr[:1])[0]
    # the single pair with one column split and with the wrapper's choice,
    # on integer and on non-integer descriptors: the bits must not depend on S
    S_single = nm.column_splits(1, n1, n2, dev)
    pair0 = [tuple(x[:1].contiguous() for x in (d_i, d_j, li, hj, mi, mj, thr))
             for d_i, d_j in ((dif, djf), (din, djn))]
    by_split = [[nm._launch_f32(ops, 1, n1, n2, splits=S) for S in (1, S_single)]
                for ops in pair0]
    torch.cuda.synchronize()

    assert torch.equal(a, plain), "nn2_batched_i8 differs from its plain version"
    assert torch.equal(a, b), "nn2_batched_i8: two launches differ"
    assert torch.equal(f, a), "nn2_batched on integer descriptors differs from the int8 kernel"
    s_packed = torch.stack([s[0], s[1], s[2].float()])
    assert torch.equal(s_packed, a[0]) and torch.equal(s_packed, s_plain), "nn2_single differs"
    assert S_single > 1, S_single
    for one, chosen in by_split:
        assert torch.equal(one, chosen), "the f32 kernel's bits depend on its column split"
    assert torch.equal(by_split[1][0], fn[:1]), "one pair alone differs from its row of the batch"
    # non-integer descriptors: distances are differences of terms up to
    # S = max sq_i + max sq_j, summed in other orders by kernel and cuBLAS
    S = float((din * din).sum(-1).max() + (djn * djn).sum(-1).max())
    tol = 16 * torch.finfo(torch.float32).eps * S
    err_f = float((fn[:, :2] - fn_plain[:, :2]).abs().max())
    # an argmin may move only between two columns within 2 tol of each other
    moved = fn[:, 2] != fn_plain[:, 2]
    argmin_diff = float(moved.float().mean())
    near_tie = bool(((fn_plain[:, 1] - fn_plain[:, 0])[moved] <= 2 * tol).all())
    assert err_f <= tol and near_tie, (err_f, tol, argmin_diff)

    def d1_error_to_exact(res):
        """d1 minus the exact (float64) distance of its row to the column in
        idx, over the rows with a match: mean and max |.|"""
        found = res[:, 0] < nm.BIG
        d_at = torch.gather(djn, 1, res[:, 2].long()[..., None].expand(-1, -1, 128))
        e = (res[:, 0].double() - ((din.double() - d_at.double()) ** 2).sum(-1))[found]
        return float(e.mean()), float(e.abs().max())

    bias = {"kernel": d1_error_to_exact(fn), "plain": d1_error_to_exact(fn_plain)}
    # the tensor cores truncate where they add: the kernel adds each k-step's
    # sum round-to-nearest, bounded as in
    # tests/test_torch_cuda.py::test_nn2_f32_kernel_bias_against_exact_distances
    eps_S = torch.finfo(torch.float32).eps * S
    assert abs(bias["kernel"][0]) <= 0.5 * eps_S and bias["kernel"][1] <= tol, (bias, eps_S)
    # every row with a match within 2 tol of its exact nearest valid, gated
    # column
    excess, excess_rows = excess_over_exact_minimum(fn, din, djn, li, hj, mi, mj, thr)
    assert excess <= 2 * tol, (excess, tol)
    n_valid = int(mi.sum())
    n_found = int((a[:, 0] < nm.BIG).sum())
    log("2-NN at the largest of slice C's {} staged chunks: B={} n1={} n2={} ({} valid rows, "
        "{} with a neighbour); int8 kernel bit-identical to plain and repeatable; f32 kernel "
        "on the same integer descriptors bit-identical; f32 on non-integer descriptors "
        "max|err| {:.3g} (tolerance {:.3g} = 16 ulp of S={:.4g}), argmin differs in {:.2e} of "
        "rows; single-pair entry equal to row 0; one pair with S = 1 and with the wrapper's "
        "S = {} column splits bit-identical (integer and non-integer descriptors)".format(
            n_chunks, B, n1, n2, n_valid, n_found, err_f, tol, S, argmin_diff, S_single))
    log("f32 on non-integer descriptors, d1 minus the exact distance to its column: kernel "
        "mean {:.4g} ({:.3f} eps * S) max|.| {:.4g}, plain mean {:.4g} max|.| {:.4g} (eps * S "
        "{:.4g}; bound on the kernel's mean 0.5 eps * S; PR 7's kernel, main products in two "
        "tensor-core chains: mean +0.1795, 2.8 eps * S); exact distance to the kernel's column "
        "over the exact minimum of the valid, gated columns: max {:.4g} on {} rows (bound "
        "2 tol = {:.4g})".format(bias["kernel"][0], bias["kernel"][0] / eps_S, bias["kernel"][1],
                                 *bias["plain"], eps_S, excess, excess_rows, 2 * tol))

    # a yardstick only (the port never calls it): cuBLAS's full-f32 batched
    # product of the cross term alone, TF32 off as the port pins it
    cross = torch.empty((B, n1, n2), dtype=torch.float32, device=dev)
    bmm_ms = cuda_ms(lambda: torch.bmm(din, djn.transpose(1, 2), out=cross), 5)
    del cross
    torch.cuda.empty_cache()
    log("yardstick: torch.bmm of the f32 cross term alone at B={} n1={} n2={} (TF32 off): "
        "{:.4f} ms".format(B, n1, n2, bmm_ms))

    out = {"bmm_cross_f32_ms": bmm_ms, "single_splits": S_single, "d1_bias": bias,
           "eps_S": eps_S, "excess_over_exact_min": excess, "excess_rows": excess_rows}
    plain_rounds = 3
    cases = (
        ("nn2_batched_i8", lambda: nm.nn2_batched_i8(di, dj, li, hj, mi, mj, thr),
         lambda: nm.nn2_plain(di, dj, li, hj, mi, mj, thr), 20, mi, mj, 128, PEAK_I8_TC_PER_S, 0.0),
        ("nn2_batched", lambda: nm.nn2_batched(din, djn, li, hj, mi, mj, thr),
         lambda: nm.nn2_plain(din, djn, li, hj, mi, mj, thr), 10, mi, mj, 512,
         PEAK_TF32_TC_PER_S, err_f),
        ("nn2_single", lambda: nm.nn2_single(dif[0], djf[0], li[0], hj[0], mi[0], mj[0], thr0),
         lambda: nm.nn2_plain(dif[:1], djf[:1], li[:1], hj[:1], mi[:1], mj[:1], thr[:1]), 50,
         mi[:1], mj[:1], 512, PEAK_TF32_TC_PER_S, 0.0),
    )
    for name, fn_k, fn_p, reps, m_i, m_j, desc_bytes, peak, err in cases:
        ms = cuda_ms(fn_k, reps)
        plain_ms = cuda_ms(fn_p, 1, rounds=plain_rounds)
        bound_ms, bound_by, ops, nbytes = nn2_bound(m_i, m_j, desc_bytes, peak)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "ops": ops, "bytes": nbytes, "max_abs_err": err,
                     "tops": ops / ms / 1e9, "bound_share": bound_ms / ms,
                     "shape": {"B": int(m_i.shape[0]), "n1": n1, "n2": n2}}
        floor = ""
        if name != "nn2_batched_i8":
            # the TF32 split runs three products: the least time of that design
            floor_ms = 3 * ops / peak * 1e3
            floor = ", 3x floor of the TF32 split {:.4f} ms ({:.1%} of it)".format(
                floor_ms, floor_ms / ms)
        if name in NN2_F32_BEFORE_MS:
            floor += "; before the rounding repair {:.4f} ms (PR 10, another call)".format(
                NN2_F32_BEFORE_MS[name])
        log("{}: kernel {:.4f} ms ({:.1f} TOP/s, {:.1%} of the bound), plain {:.4f} ms, bound "
            "{:.4f} ms ({}; {:.3g} ops, {:.1f} MB){}".format(
                name, ms, ops / ms / 1e9, bound_ms / ms, plain_ms, bound_ms, bound_by, ops,
                nbytes / 1e6, floor))
    return out


def ptxas_summary(log_text):
    """{kernel: "N registers, spills, shared memory"} from nvcc -Xptxas -v
    output."""
    import re

    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Function properties for \S*?\d+((?:nn2|schur|sift|rpc)_[a-z0-9_]+?)"
                      r"(ILi(\d+)E)?E", line)
        if m:
            name = m.group(1) + ("<{}>".format(m.group(3)) if m.group(3) else "")
        elif name and "spill stores" in line:
            out[name] = line.strip()
        elif name and line.strip().startswith("ptxas info    : Used"):
            out[name] = line.split(": Used", 1)[1].strip() + "; " + out.get(name, "")
            name = None
    return out


def sift_stage_trace(image, dev, n_kp=1024):
    """The port's SIFT stages on one frame, in the order detection runs
    them: octave 0's pyramid, extrema and refinement, then the scale,
    gradients, orientations and descriptor of its first n_kp valid
    keypoints. Returns [(stage, op, tensor on the host)]."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from sat_bundleadjust_tpu_torch.ops import sift

    out = []

    def rec(stage, op, t):
        out.append((stage, op, t.detach().cpu()))

    with torch.no_grad():
        im = sift._normalized_stack([image], torch.device(dev))
        up = sift.upsample2(im)
        rec("2x upsampling", "upsample2 (csrc/sift_blur.cu; _upsample_axis on the CPU)", up)
        sig_inc = torch.as_tensor(sift._sig_inc(sift.N_SPO), device=dev)
        taps = [sift._dynamic_taps(sig_inc[s], sift._MAX_BLUR_RADIUS)
                for s in range(sift.N_SPO + 2)]
        rec("blur taps", "_dynamic_taps (_exp_f32, sum, division)", torch.stack(taps))
        sigma_extra = float(np.sqrt(sift.SIGMA_MIN ** 2 - sift.SIGMA_IN ** 2) / sift.DELTA_MIN)
        ss = [sift._blur(up, sigma_extra)]
        rec("blur", "blur, fixed taps (csrc/sift_blur.cu; _accumulate on the CPU)", ss[0])
        for s in range(sift.N_SPO + 2):
            ss.append(sift.blur(ss[-1], taps[s]))
        ss = torch.stack(ss, dim=1)[0]
        rec("blur", "blur, traced taps (csrc/sift_blur.cu; _accumulate on the CPU)", ss)
        dog = ss[1:] - ss[:-1]
        rec("DoG", "subtraction", dog)
        rec("extrema", "max_pool3d", F.max_pool3d(dog[None, None], 3, stride=1,
                                                  padding=(0, 1, 1))[0, 0])
        _, H, W = dog.shape
        slots = int(min(sift.MAX_KP_PER_OCTAVE, max(192, (H * W) // 128)))
        kp = sift._extrema_and_refine(dog, torch.tensor(0.0133, device=dev), slots)
        rec("sub-pixel refinement", "_extrema_and_refine (top-k sort, _inv3x3)",
            torch.stack([kp["x"], kp["y"], kp["s"], kp["value"], kp["valid"].float()]))
        sel = torch.nonzero(kp["valid"])[:n_kp, 0]
        x, y, s_kp = kp["x"][sel], kp["y"][sel], kp["s"][sel]
        sigma = sift._sigma_oct(s_kp, sift.N_SPO)
        rec("keypoint scale", "_sigma_oct (_exp2_f32 of _div(s, 3))", sigma)
        level = torch.clamp(torch.round(s_kp).to(torch.int64), 0, sift.N_SPO + 2)
        mag, ang, dx, dy = sift._gradients(ss, x, y, level)
        rec("gradients", "magnitude (_hypot_f32)", mag)
        rec("gradients", "angle (_atan2_f32)", ang)
        th1, th2, v2 = sift._orientation(mag, ang, dx, dy, sigma)
        rec("orientation histograms", "_orientation (_exp_via_f64 weights, _fixed_point sums "
            "by scatter_add_, _div smoothing, peaks)",
            torch.stack([th1, th2, v2.float()]))
        rec("descriptor", "_descriptor (_sincos_f32 rotation, _exp_via_f64 weights, "
            "_fixed_point sums by scatter_add_, _tree_sum norms, quantization)",
            sift._descriptor(mag, ang, dx, dy, sigma, th1))
    return out


def sift_first_difference(card, cpu):
    """The stages of two traces side by side: [(stage, op, differing
    elements, elements, max |difference|)] and the first that differs."""
    rows, first = [], None
    for (stage, op, a), (_, _, b) in zip(card, cpu):
        if a.shape != b.shape:
            row = (stage, op, -1, b.numel(), float("inf"))
        else:
            diff = a.double() - b.double()
            row = (stage, op, int((a != b).sum()), b.numel(), float(diff.abs().max()))
        rows.append(row)
        if first is None and row[2] != 0:
            first = row
    return first, rows


def _ulps(a, b):
    """|a - b| in units of float32 spacing at b (numpy)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float32)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(b), np.float32(1e-30)))


def sift_suspects(dev, n=1 << 20):
    """The elementary functions and reductions of the SIFT stages, each on
    the same seeded inputs on the card and on the CPU: [(op, differing
    results, results, max ulps)]."""
    import numpy as np
    import torch

    from sat_bundleadjust_tpu_torch.ops import sift

    rng = np.random.RandomState(11)
    f32 = np.float32
    g = (rng.randn(n) * 0.02).astype(f32)
    h = (rng.randn(n) * 0.02).astype(f32)
    theta = rng.uniform(-np.pi, np.pi, n).astype(f32)
    neg = rng.uniform(-30.0, 0.0, n).astype(f32)
    expo = rng.uniform(0.0, 8.0 / 3.0, n).astype(f32)
    ints = np.floor(rng.uniform(-126, 1, n)).astype(f32)
    a, b, c = (rng.rand(3, n).astype(f32) - f32(0.5))
    K, S = 512, 1681
    wm = (rng.rand(K, S) * 0.01).astype(f32)
    bins = rng.randint(0, 36, (K, S)).astype(f32)
    lhs = (rng.rand(K, 16, S) * 0.01).astype(f32)
    wo = rng.rand(K, S, 8).astype(f32)
    d = (rng.rand(K, 128) * 0.3).astype(f32)
    # K keypoints' gradient patches as _gradients gives them: magnitudes,
    # angles, the grid's offsets and the keypoints' scales
    P = 2 * sift._PATCH_R + 1
    off = rng.uniform(-0.5, 0.5, (K, 2)).astype(f32)
    grid = np.arange(P, dtype=f32) - sift._PATCH_R
    patches = (np.abs(rng.randn(K, P, P) * 0.02).astype(f32),
               rng.uniform(-np.pi, np.pi, (K, P, P)).astype(f32),
               (grid[None] - off[:, :1]).astype(f32), (grid[None] - off[:, 1:]).astype(f32),
               rng.uniform(1.6, 3.2, K).astype(f32))
    cases = [
        ("_fma (float64 product and TwoSum, round to odd)", sift._fma, (a, b, c)),
        ("_exp_f32", sift._exp_f32, (neg,)),
        ("torch.exp2 of integers", torch.exp2, (ints,)),
        ("x / 3.0 (a Python float divisor)", lambda x: x / 3.0, (g,)),
        ("torch.hypot", torch.hypot, (g, h)),
        ("torch.atan2", torch.atan2, (g, h)),
        ("torch.exp", torch.exp, (neg,)),
        ("torch.sin", torch.sin, (theta,)),
        ("torch.cos", torch.cos, (theta,)),
        ("torch.pow(2, x)", lambda x: torch.pow(2.0, x), (expo,)),
        ("masked sum over 1681 samples", lambda w, q: torch.sum(w * (q == 5), dim=1),
         (wm, bins)),
        ("torch.bmm (K, 16, 1681) x (K, 1681, 8)", torch.bmm, (lhs, wo)),
        ("torch.linalg.vector_norm over 128 bins",
         lambda x: torch.linalg.vector_norm(x, dim=1), (d,)),
        # the port's own versions of the above, which the stages run
        ("sift._div(x, 3.0)", lambda x: sift._div(x, 3.0), (g,)),
        ("sift._hypot_f32", sift._hypot_f32, (g, h)),
        ("sift._atan2_f32", sift._atan2_f32, (g, h)),
        ("sift._exp_via_f64", sift._exp_via_f64, (neg,)),
        ("sift._sincos_f32 (sin)", lambda x: sift._sincos_f32(x)[0], (theta,)),
        ("sift._sincos_f32 (cos)", lambda x: sift._sincos_f32(x)[1], (theta,)),
        ("sift._exp2_f32", sift._exp2_f32, (expo,)),
        ("sift._tree_sum over 128 bins", lambda x: sift._tree_sum(x.t().contiguous()), (d,)),
        ("sift._orientation (seeded patches)",
         lambda *a: torch.stack(sift._orientation(*a)[:2]), patches),
        ("sift._descriptor (seeded patches)", sift._descriptor, patches + (theta[:K],)),
    ]
    out = []
    with torch.no_grad():
        for name, fn, args in cases:
            on_cpu = fn(*[torch.as_tensor(x) for x in args]).numpy()
            on_card = fn(*[torch.as_tensor(x, device=dev) for x in args]).cpu().numpy()
            out.append((name, int((on_card != on_cpu).sum()), on_cpu.size,
                        float(_ulps(on_card, on_cpu).max())))
    return out


def sift_compare(f_card, f_cpu, pos_tol=0.01):
    """Card keypoints against CPU keypoints (N, 132): each card keypoint
    paired with its nearest CPU keypoint in (col, row, scale), the closest
    orientation among equally near ones. Unmatched: no counterpart within
    pos_tol (tests/test_torch_sift.py's POS_TOL) either way. The CPU bars of
    tests/test_torch_sift.py on the CPU's keypoints: the share with a card
    keypoint within pos_tol, and of those the share whose nearest
    descriptor is equal."""
    import numpy as np
    from scipy.spatial import cKDTree

    def nearest(f_from, f_to):
        d, k = cKDTree(f_to[:, :3]).query(f_from[:, :3], k=min(4, len(f_to)))
        d, k = d.reshape(len(f_from), -1), k.reshape(len(f_from), -1)
        dth = np.abs(f_to[k, 3] - f_from[:, None, 3])
        dth = np.minimum(dth, 2 * np.pi - dth)
        dth = np.where(d <= d[:, :1] + 1e-9, dth, np.inf)
        pick = np.argmin(dth, axis=1)
        rows = np.arange(len(f_from))
        return d[rows, pick], k[rows, pick]

    d_card, k_card = nearest(f_card, f_cpu)
    d_cpu, _ = nearest(f_cpu, f_card)
    m = d_card <= pos_tol
    a, b = f_card[m], f_cpu[k_card[m]]
    dpos = np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1])
    dth = np.abs(a[:, 3] - b[:, 3])
    dth = np.minimum(dth, 2 * np.pi - dth)
    ddesc = np.abs(a[:, 4:] - b[:, 4:]).max(axis=1)
    near = cKDTree(f_card[:, :2]).query_ball_point(f_cpu[:, :2], pos_tol)
    found = np.array([len(c) > 0 for c in near])
    best = np.array([np.abs(f_card[c, 4:] - f_cpu[i, 4:]).max(1).min()
                     for i, c in enumerate(near) if c])

    def q(x, p):
        return float(np.percentile(x, p)) if len(x) else 0.0

    return {
        "card": int(len(f_card)), "cpu": int(len(f_cpu)),
        "identical": bool(f_card.shape == f_cpu.shape and np.array_equal(f_card, f_cpu)),
        "unmatched_card": int((~m).sum()), "unmatched_cpu": int((d_cpu > pos_tol).sum()),
        "dpos_max": q(dpos, 100), "dpos_p99": q(dpos, 99),
        "dscale_max": q(np.abs(a[:, 2] - b[:, 2]), 100),
        "dscale_p99": q(np.abs(a[:, 2] - b[:, 2]), 99),
        "dtheta_max": q(dth, 100), "dtheta_p99": q(dth, 99),
        "desc_equal": float((ddesc == 0).mean()) if len(ddesc) else 0.0,
        "desc_max_bin_diff": float(ddesc.max()) if len(ddesc) else 0.0,
        "positions_within_tol": float(found.mean()),
        "desc_equal_within_tol": float((best == 0).mean()) if len(best) else 0.0,
    }


def sift_compare_line(label, r):
    return ("SIFT {}: card {} keypoints, CPU {}; identical arrays: {}; unmatched within {} px "
            "(card -> CPU / CPU -> card) {} / {}; matched |d position| max {:.3g} p99 {:.3g} px, "
            "|d scale| max {:.3g} p99 {:.3g}, |d orientation| max {:.3g} p99 {:.3g} rad; "
            "descriptors equal {:.4%}, largest bin difference {:g}; CPU bars: positions within "
            "0.01 px {:.4%}, descriptors equal {:.4%}".format(
                label, r["card"], r["cpu"], r["identical"], 0.01, r["unmatched_card"],
                r["unmatched_cpu"], r["dpos_max"], r["dpos_p99"], r["dscale_max"],
                r["dscale_p99"], r["dtheta_max"], r["dtheta_p99"], r["desc_equal"],
                r["desc_max_bin_diff"], r["positions_within_tol"],
                r["desc_equal_within_tol"]))


def sift_device_check(dev, images, ft, c):
    """The card's SIFT against the CPU's: a 512x512 render and slice C's
    frame 0 (2000x2000) detected on both, matched keypoint by keypoint; the
    stages of each frame traced on both devices from the same input (the
    first tensor that differs); the elementary functions and reductions of
    the stages on the same inputs; and slice C's tracks and BA rerun with
    the CPU's keypoints for frame 0."""
    import numpy as np

    from sat_bundleadjust_tpu_torch.ops import sift
    from sat_bundleadjust_tpu_torch.tracks.detection import _top_k_by_scale
    from sat_bundleadjust_tpu_torch.utils import demo

    rec = {}
    ims, _ = demo.render_synthetic_images(n_cam=1, h=512, w=512, seed=0, alt=0.0, device=dev)
    frame0 = np.asarray(images[0].geotiff_path, np.float32)
    kp_max = SLICE_C_TRACKS_CONFIG["FT_kp_max"]
    card0 = ft.features[0][~np.isnan(ft.features[0][:, 0])]
    for label, image, f_card in (("512x512", ims[0], None), ("2000x2000 (slice C frame 0)",
                                                              frame0, card0)):
        t0 = time.time()
        if f_card is None:
            f_card = sift.detect_sift(image, device=dev)
        t1 = time.time()
        f_cpu = _top_k_by_scale(sift.detect_sift(image, max_kp=kp_max, device="cpu"), None)
        t2 = time.time()
        r = sift_compare(_top_k_by_scale(f_card, None), f_cpu)
        r.update(card_s=t1 - t0, cpu_s=t2 - t1)
        log(sift_compare_line(label, r) + "; card {:.2f} s, CPU {:.2f} s".format(
            r["card_s"], r["cpu_s"]))
        r["cpu_features"] = f_cpu
        rec[label] = r
    # the stages of the 512x512 frame, each device from the same input
    first, rows = sift_first_difference(sift_stage_trace(ims[0], dev),
                                        sift_stage_trace(ims[0], "cpu"))
    for row in rows:
        log("  512x512 stage {} [{}]: {} of {} elements differ, max |d| {:.3g}".format(*row))
    log("  512x512: first stage that differs: {}".format(
        "none (identical)" if first is None else "{} [{}]".format(*first[:2])))
    rec["stages"] = rows
    rec["first_difference"] = None if first is None else first[:2]
    suspects = sift_suspects(dev)
    for name, n_diff, n, ulps in suspects:
        log("  op {}: {} of {} results differ between card and CPU (max {:.3g} ulp)".format(
            name, n_diff, n, ulps))
    rec["suspects"] = suspects

    # slice C's tracks and BA with the CPU's keypoints for frame 0
    f_cpu0 = rec["2000x2000 (slice C frame 0)"].pop("cpu_features")
    rec["512x512"].pop("cpu_features")
    tracks_cpu, l2_cpu = slice_c_tracks_with(ft, images, dev, _top_k_by_scale(f_cpu0, kp_max))
    rec["tracks"] = {"card": c["tracks"], "card_l2_px": c["l2"]["reproj_after_mean"],
                     "cpu_frame0": tracks_cpu, "cpu_frame0_l2_px": l2_cpu}
    log("slice C's tracks with frame 0's keypoints from the card / from the CPU: {} / {} "
        "tracks, L2 {:.6f} / {:.6f} px".format(c["tracks"], tracks_cpu,
                                               c["l2"]["reproj_after_mean"], l2_cpu))
    # the bar of tests/test_torch_cuda.py::test_sift_on_the_card_gives_the_cpu_arrays
    for label in ("512x512", "2000x2000 (slice C frame 0)"):
        r = rec[label]
        assert r["cpu"] > 100 and r["identical"], {k: v for k, v in r.items() if k != "stages"}
    assert rec["first_difference"] is None, rec["first_difference"]
    return rec


def check_sift_blur(dev):
    """csrc/sift_blur.cu at rpc_date10.cli's batch: the 2x upsample of 10
    frames of 2000x2000 px and the fixed-radius blur (r = 13) of the
    10 x 4000 x 4000 first octave, each against its plain version on the
    card (bit for bit) and timed (CUDA events) against its bound and the
    plain version; then the pyramid's whole chain of blurs of that batch,
    timed against its bound."""
    import numpy as np
    import torch

    from sat_bundleadjust_tpu_torch.ops import sift

    B, h, w = SIFT_BLUR_BATCH
    im = torch.rand((B, h, w), device=dev, generator=torch.Generator(dev).manual_seed(0))
    taps = sift._dynamic_taps(torch.as_tensor(sift._sig_inc(sift.N_SPO), device=dev)[0],
                              sift._MAX_BLUR_RADIUS)
    up = sift.upsample2(im)
    same_up = bool(torch.equal(up.view(torch.int32), sift._upsample_plain(im).view(torch.int32)))
    out = sift.blur(up, taps)
    same_blur = bool(torch.equal(out.view(torch.int32), sift._blur_plain(up, taps).view(torch.int32)))
    torch.cuda.synchronize()
    rec = {"shape": {"B": B, "h": h, "w": w, "radius": sift._MAX_BLUR_RADIUS},
           "bit_identical": {"upsample2": same_up, "blur": same_blur}}
    n_in, n = im.numel(), up.numel()
    k = taps.numel()
    # least work: a blur level reads and writes each pixel once and makes
    # 2 k fmas a pixel (2 flops each); the upsample reads the frames and
    # writes 4 px each (a few flops a pixel, far below its bytes)
    bounds = {
        "blur": (8 * n / PEAK_BYTES_PER_S * 1e3, 4 * k * n / PEAK_F32_PER_S * 1e3),
        "upsample2": (4 * (n_in + n) / PEAK_BYTES_PER_S * 1e3, 6 * n / PEAK_F32_PER_S * 1e3),
    }
    runs = {
        "blur": (lambda: sift.blur(up, taps, out=out), lambda: sift._blur_plain(up, taps)),
        "upsample2": (lambda: sift.upsample2(im), lambda: sift._upsample_plain(im)),
    }
    for name, (kernel, plain) in runs.items():
        t_bytes, t_ops = bounds[name]
        r = {"ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 1, rounds=3),
             "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
             "operations"}
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        rec[name] = r
        log("sift {} [{} x {}x{} -> {}x{}{}]: bit-identical to the plain version {}; {:.4f} ms, "
            "bound {:.4f} ms ({}; {:.1%} of it), plain version {:.1f} ms".format(
                name, B, h, w, 2 * h, 2 * w, ", r = {}".format(rec["shape"]["radius"])
                if name == "blur" else "", rec["bit_identical"][name], r["ms"], r["bound_ms"],
                r["bound_by"], r["share_of_bound"], r["plain_ms"]))
    # the pyramid's whole chain of one batch, as _pyramid_extrema runs it:
    # the upsample, the first blur (host taps, r = 5), then 5 blurs an
    # octave into its (B, S, H, W) slots, the next octave's first level
    # copied from level 3
    sigma_extra = float(np.sqrt(sift.SIGMA_MIN ** 2 - sift.SIGMA_IN ** 2) / sift.DELTA_MIN)
    level_taps = [sift._dynamic_taps(torch.as_tensor(sift._sig_inc(sift.N_SPO), device=dev)[s],
                                     sift._MAX_BLUR_RADIUS) for s in range(sift.N_SPO + 2)]
    S = sift.N_SPO + 3

    def chain():
        first = sift._blur(sift.upsample2(im), sigma_extra)
        for _o in range(8):
            if min(first.shape[1:]) < 12:
                break
            ss = first.new_empty((B, S, *first.shape[1:]))
            ss[:, 0] = first
            for s in range(S - 1):
                sift.blur(ss[:, s], level_taps[s], out=ss[:, s + 1])
            first = ss[:, sift.N_SPO, ::2, ::2]

    blurred, H, W = 0, 2 * h, 2 * w  # pixels of all blur levels
    for o in range(8):
        if min(H, W) < 12:
            break
        blurred += B * H * W * ((S - 1) + (o == 0))
        H, W = (H + 1) // 2, (W + 1) // 2
    launches = sift.blur.launches + sift.upsample2.launches
    chain()
    launches = sift.blur.launches + sift.upsample2.launches - launches
    r = {"ms": cuda_ms(chain, 3), "launches": launches,
         "bound_ms": (8 * blurred + 4 * (n_in + n)) / PEAK_BYTES_PER_S * 1e3}
    rec["chain"] = r
    log("sift pyramid's blurs of one batch [{} x {}x{}]: {} launches, {:.4f} ms, bound {:.4f} ms "
        "(bytes: each level read and written once; {:.1%} of it)".format(
            B, h, w, launches, r["ms"], r["bound_ms"], r["bound_ms"] / r["ms"]))
    assert same_up and same_blur, rec["bit_identical"]
    return rec


def rpc_triangulate_flops(steps, newton):
    """float64 operations of the RPC altitude search of duos that took
    `steps` secant steps (an fma counted as 2, a division as 1), as
    csrc/rpc_triangulate.cu writes it: a Newton step 4 x 37 fmas of the
    polynomials and derivatives, 23 products of monomials, 14 operations of
    the two quotients and 15 of the 2x2 step; a localization 10 more; a
    projection 180; a secant step 23 besides its two correspondences; the
    final localization."""
    localization = newton * (4 * 37 * 2 + 23 + 14 + 15) + 10
    return steps * (2 * (localization + 180) + 23) + localization


def check_rpc_triangulate(dev):
    """csrc/rpc_triangulate.cu at rpc_ba1000_clean.robust's shape: against
    the plain version on the card (index_rpc and rpc_triangulation in
    CHUNK-duo chunks, as the CPU runs it), and timed (CUDA events) against
    its float64 bound and the plain version; the order (argsort by camera
    a) timed alone."""
    import numpy as np
    import torch

    from sat_bundleadjust_tpu_torch.models import ellipsoid
    from sat_bundleadjust_tpu_torch.models.rpc import (NEWTON_ITERS, index_rpc,
                                                       rpc_projection, stack_rpcs)
    from sat_bundleadjust_tpu_torch.ops import triangulate as ttri
    from sat_bundleadjust_tpu_torch.utils import demo

    M, D, stride = (RPC_TRIANGULATE_SHAPE[k] for k in ("cameras", "duos", "stride"))
    views = [(stride * i) % M for i in range(M)]
    rpcs = stack_rpcs([demo.make_synthetic_rpc(view_dx=300.0 * np.cos(2 * np.pi * k / M),
                                               view_dy=300.0 * np.sin(2 * np.pi * k / M))
                       for k in views], dev)
    g = torch.Generator(dev).manual_seed(0)
    ca = torch.randint(0, M, (D,), device=dev, generator=g)
    cb = (ca + torch.randint(1, M, (D,), device=dev, generator=g)) % M
    u = torch.rand((3, D), dtype=torch.float64, device=dev, generator=g) * 2 - 1
    lon = rpcs.lon_offset[0] + 0.9 * rpcs.lon_scale[0] * u[0]
    lat = rpcs.lat_offset[0] + 0.9 * rpcs.lat_scale[0] * u[1]
    h = 50.0 + 450.0 * u[2]
    pa = torch.stack(rpc_projection(index_rpc(rpcs, ca), lon, lat, h), dim=-1)
    pb = torch.stack(rpc_projection(index_rpc(rpcs, cb), lon, lat, h), dim=-1)
    pb = pb + 0.1 * torch.randn((D, 2), dtype=torch.float64, device=dev, generator=g)

    def plain():
        return [ttri.rpc_triangulation(index_rpc(rpcs, ca[s:s + ttri.CHUNK]),
                                       index_rpc(rpcs, cb[s:s + ttri.CHUNK]),
                                       pa[s:s + ttri.CHUNK], pb[s:s + ttri.CHUNK])
                for s in range(0, D, ttri.CHUNK)]

    launches = ttri.rpc_triangulate.launches
    out = ttri._rpc_kernel(rpcs, ca, cb, pa, pb)
    want = plain()
    torch.cuda.synchronize()
    assert ttri.rpc_triangulate.launches == launches + 1
    pts_p, err_p = (torch.cat(t) for t in zip(*want))
    gap_m = float((ellipsoid.latlon_to_ecef_arr(out[1], out[0], out[2]) - pts_p).norm(dim=1).max())
    gap_px = float((out[3] - err_p).abs().max())
    steps = torch.bincount(out[4].long()).tolist()
    flops = sum(n * rpc_triangulate_flops(k, NEWTON_ITERS) for k, n in enumerate(steps))
    # bytes: a duo's order, two camera indices, two pixels in, five rows out
    t_ops, t_bytes = flops / PEAK_F64_PER_S * 1e3, (D * 96 + M * 90 * 8) / PEAK_BYTES_PER_S * 1e3
    r = {"shape": {"cameras": M, "duos": D}, "steps": steps, "gflop": flops / 1e9,
         "max_point_gap_m": gap_m, "max_err_gap_px": gap_px,
         "ms": cuda_ms(lambda: ttri._rpc_kernel(rpcs, ca, cb, pa, pb), 20),
         "order_ms": cuda_ms(lambda: torch.argsort(ca), 20),
         "plain_ms": cuda_ms(plain, 1, rounds=3),
         "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    log("rpc_triangulate [{} duos, {} cameras; secant steps {}]: points within {:.3g} m and "
        "err within {:.3g} px of the plain version; {:.4f} ms (its argsort {:.4f}), bound "
        "{:.4f} ms ({}: {:.2f} GFLOP at 34 TFLOP/s f64; {:.1%} of it), plain version {:.1f} "
        "ms".format(D, M, steps, gap_m, gap_px, r["ms"], r["order_ms"], r["bound_ms"],
                    r["bound_by"], r["gflop"], r["share_of_bound"], r["plain_ms"]))
    assert gap_m <= 1e-4 and gap_px <= 1e-6, r
    return r


def slice_c_tracks_with(ft, images, dev, features0):
    """Slice C's matching, tracks and BA rounds again, with frame 0's
    keypoints replaced by features0. Returns (tracks, L2 mean error)."""
    import tempfile

    from sat_bundleadjust_tpu_torch.tracks import matching

    saved = (ft.features[0], ft.features_utm[0], ft.config["in_dir"], ft.config["out_dir"],
             ft.pairwise_matches)
    im = images[0]
    try:
        with tempfile.TemporaryDirectory(prefix="slice_c_cpu0_") as d:
            ft.config["in_dir"] = ft.config["out_dir"] = d
            ft.features[0] = features0
            ft.features_utm[0] = matching.keypoints_to_utm_coords(features0, im.rpc, im.offset,
                                                                  im.alt or 0.0)
            ft.run_feature_matching()
            bundle = ft.get_feature_tracks()
    finally:
        (ft.features[0], ft.features_utm[0], ft.config["in_dir"], ft.config["out_dir"],
         ft.pairwise_matches) = saved
    _, _, _, l2 = tracks_ba(bundle, images, dev, "slice C (frame 0 from the CPU)")
    return int(bundle["C"].shape[1]), l2["reproj_after_mean"]


def tracks_ba(bundle, images, dev, label):
    """A track bundle through the BA stage: triangulation, soft-L1, outlier
    removal, L2. Returns (p, p2, soft, l2)."""
    from sat_bundleadjust_tpu_torch.ba import outliers
    from sat_bundleadjust_tpu_torch.ba.params import BAParams
    from sat_bundleadjust_tpu_torch.ba.solver import BASolver
    from sat_bundleadjust_tpu_torch.ops.triangulate import init_pts3d

    C = bundle["C"]
    pts3d = init_pts3d(C, [im.rpc for im in images], "rpc", bundle["pairs_to_triangulate"],
                       device=dev)
    p = BAParams(C, pts3d, [im.rpc for im in images], "rpc", bundle["pairs_to_triangulate"],
                 [im.center for im in images], {"verbose": False})
    _, _, e_soft, soft = solve_round(BASolver(p, device=dev), SOFT_L1, label + " soft-L1")
    p2 = outliers.rm_outliers(e_soft, p, device=dev)
    _, _, _, l2 = solve_round(BASolver(p2, device=dev), None, label + " L2")
    return p, p2, soft, l2


def slice_i(dev, counters, images, ft):
    """The package's single-image and single-pair entry points on slice C's
    frames and tracks front end: detect_tpu on frame 0 with a mask over the
    central half against slice C's batched detection; init_F_pair_to_match
    of every pair against init_F_pairs_batched; match_pair on the card (the
    single-pair kernel at full width) for three pairs against the staged
    path's matches; the rotation conversions and RPCModel's methods on the
    card."""
    import numpy as np
    import torch

    from sat_bundleadjust_tpu_torch.models import rotations as rot
    from sat_bundleadjust_tpu_torch.models.rpc import (map_rpc, rpc_localization,
                                                       rpc_projection)
    from sat_bundleadjust_tpu_torch.ops import match as match_ops
    from sat_bundleadjust_tpu_torch.ops import nn2_match as nm
    from sat_bundleadjust_tpu_torch.tracks import detection, matching
    from sat_bundleadjust_tpu_torch.utils.geo import geojson_to_polygon

    cfg = ft.config
    h, w = SLICE_C["h"], SLICE_C["w"]
    mask = np.zeros((h, w), np.uint8)
    mask[h // 4:3 * h // 4, w // 4:3 * w // 4] = 1
    frame0 = np.asarray(images[0].geotiff_path, np.float32)
    pairs = [tuple(q) for q in ft.pairs_to_match]
    F_batched = matching.init_F_pairs_batched(pairs, images)
    matched = []
    for q, (i, j) in enumerate(pairs[:SLICE_I_PAIRS]):
        poly = geojson_to_polygon(ft.footprints[i]["geojson"]).intersection(
            geojson_to_polygon(ft.footprints[j]["geojson"]))
        idx_i, idx_j = matching.utm_bbox_indices(ft.features_utm[i], ft.features_utm[j], poly)
        matched.append((q, i, j, idx_i, idx_j))

    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    single = detection.detect_tpu(frame0, mask=mask, max_kp=int(cfg["FT_kp_max"]), device=dev)
    t1 = time.time()
    F_single = [matching.init_F_pair_to_match(h, w, images[i].rpc, images[j].rpc)
                for (i, j) in pairs]
    t2 = time.time()
    results = []
    for q, i, j, idx_i, idx_j in matched:
        fi, fj = ft.features[i][idx_i], ft.features[j][idx_j]
        m, n_ratio, n_ransac = match_ops.match_pair(
            fi, fj, F_single[q], rel_thr=float(cfg["FT_rel_thr"]),
            abs_thr=float(cfg["FT_abs_thr"]), ransac_thr=cfg["FT_ransac"], device=dev)
        results.append((m, n_ratio, n_ransac))
    torch.cuda.synchronize()
    t3 = time.time()
    launches = {k.__name__: k.launches for k in counters}

    # after the counters are read: comparisons
    card0 = ft.features[0][~np.isnan(ft.features[0][:, 0])]
    batched = detection._apply_mask(card0, mask)
    single = detection._top_k_by_scale(single, None)
    same_detection = single.shape == batched.shape and bool(np.array_equal(single, batched))

    def unit(F, ref):
        F = F / np.linalg.norm(F)
        return -F if np.sum(F * ref) < 0 else F

    f_err = max(float(np.abs(unit(Fs, unit(Fb, Fb)) - unit(Fb, Fb)).max())
                for Fs, Fb in zip(F_single, F_batched))
    agree, per_pair = [], []
    for (q, i, j, idx_i, idx_j), (m, n_ratio, n_ransac) in zip(matched, results):
        ops = match_ops.single_pair_operands(ft.features[i][idx_i], ft.features[j][idx_j],
                                             F_single[q], match_ops.EPIPOLAR_THR, dev)
        d1, d2, nn = nm.nn2_single(*ops)
        plain = nm.nn2_plain(*[o[None] for o in ops[:6]],
                             torch.tensor([ops[6]], dtype=torch.float32, device=dev))[0]
        bits = bool(torch.equal(torch.stack([d1, d2, nn.float()]), plain))
        single_m = matching._remap_and_filter(m, idx_i, idx_j, ft.features_utm[i],
                                              ft.features_utm[j])
        pm = ft.pairwise_matches
        staged = pm[(pm[:, 2] == i) & (pm[:, 3] == j), :2]
        a = set(map(tuple, np.asarray(single_m if single_m is not None else np.zeros((0, 2)),
                                      np.int64)))
        b = set(map(tuple, staged.astype(np.int64)))
        share = len(a & b) / max(len(a | b), 1)
        agree.append(share)
        per_pair.append({"pair": (i, j), "rows": len(idx_i), "cols": len(idx_j),
                         "ratio": n_ratio, "ransac": n_ransac, "single": len(a), "staged": len(b),
                         "common": len(a & b), "agreement": share, "bit_identical": bits})
        log("slice I match_pair pair {}: {} x {} keypoints in the UTM box, {} after the ratio "
            "test, {} after RANSAC, {} after the UTM filter; staged path {}; {} in common "
            "(agreement {:.4f} of the union); nn2_single bit-identical to plain: {}".format(
                (i, j), len(idx_i), len(idx_j), n_ratio, n_ransac, len(a), len(b), len(a & b),
                share, bits))

    # rotations: 1000 seeded ones on the card, through every conversion
    rng = np.random.RandomState(7)
    ang = torch.as_tensor(rng.uniform(-np.pi, np.pi, (1000, 3)) * [1, 0.5, 1], device=dev)
    R = rot.euler_angles_to_R(*ang.unbind(1))
    q4 = rot.R_to_quaternion(R)
    rot_err = {"R -> quaternion -> R": float((rot.quaternion_to_R(*q4) - R).abs().max()),
               "quaternion -> Euler": float((torch.stack(rot.quaternion_to_euler(*q4), 1)
                                             - ang).abs().max())}
    axis, angle = rot.axis_angle_from_R(R)
    rot_err["R -> axis-angle -> R"] = float((rot.axis_angle_to_R(axis, angle) - R).abs().max())
    pts = torch.as_tensor(rng.randn(1000, 3), device=dev)
    rot_err["Rodrigues vs the matrix"] = float(
        (rot.rotate_rodrigues(pts, axis * angle[:, None]) - (R @ pts[..., None])[..., 0])
        .abs().max())
    assert all(v.device == ang.device for v in (*q4, axis, angle))

    # RPCModel's host methods against the functions on the card, per view
    g = np.linspace(-0.8, 0.8, 9)
    rpc_err = [0.0, 0.0]
    for im in images:
        r = im.rpc.to_numpy()
        LO, LA, AL = (np.asarray(v).ravel() for v in np.meshgrid(
            float(r.lon_offset) + float(r.lon_scale) * g, float(r.lat_offset)
            + float(r.lat_scale) * g, float(r.alt_offset) + float(r.alt_scale) * g[::2]))
        card = map_rpc(lambda f: torch.as_tensor(np.asarray(f, np.float64), device=dev), r)
        col, row = card.projection(LO, LA, AL)
        cc, rc = rpc_projection(card, *(torch.as_tensor(v, device=dev) for v in (LO, LA, AL)))
        rpc_err[0] = max(rpc_err[0], float(np.abs(cc.cpu().numpy() - col).max()),
                         float(np.abs(rc.cpu().numpy() - row).max()))
        lon, lat = card.localization(col, row, AL)
        lo, la = rpc_localization(card, *(torch.as_tensor(v, device=dev) for v in (col, row, AL)))
        rpc_err[1] = max(rpc_err[1], float(np.abs(lo.cpu().numpy() - lon).max()),
                         float(np.abs(la.cpu().numpy() - lat).max()))

    rec = {"launches": launches, "detect_s": t1 - t0, "F_s": t2 - t1, "match_s": t3 - t2,
           "detect_keypoints": int(single.shape[0]), "detect_identical": same_detection,
           "F_max_err": f_err, "pairs": per_pair, "agreement_min": min(agree),
           "rotation_max_err": rot_err, "rpc_projection_max_px": rpc_err[0],
           "rpc_localization_max_deg": rpc_err[1]}
    log("slice I: detect_tpu on frame 0 with a mask over the central half {:.3f} s, {} "
        "keypoints, identical to slice C's batched detection under the mask: {}; "
        "init_F_pair_to_match of {} pairs {:.3f} s, max |F - batched F| {:.3g} (normalized, "
        "sign-aligned; the CPU test's bar 1e-9); match_pair of {} pairs {:.3f} s; launches {}"
        .format(rec["detect_s"], rec["detect_keypoints"], same_detection, len(pairs), rec["F_s"],
                f_err, len(matched), rec["match_s"], launches))
    log("slice I rotations on the card (1000 seeded): " + "; ".join(
        "{} {:.3g}".format(k, v) for k, v in rot_err.items())
        + "; RPCModel.projection / localization (host) against rpc_projection / "
        "rpc_localization (card): {:.3g} px / {:.3g} deg".format(*rpc_err))
    assert same_detection and single.shape[0] > 500, (single.shape, batched.shape)
    assert f_err <= 1e-9, f_err
    assert launches["nn2_single"] == len(matched), launches
    assert launches["nn2_batched"] == launches["nn2_batched_i8"] == launches["schur_wz"] == 0
    assert all(p["bit_identical"] for p in per_pair), per_pair
    assert all(p["single"] > 100 for p in per_pair), per_pair
    assert max(rot_err.values()) <= 1e-9 and max(rpc_err) <= 1e-9, (rot_err, rpc_err)
    return rec


def slice_d(dev, counters, images):
    """The CLI in process on slice C's frames and biased RPCs written to
    disk: stage walls, refit fit errors, kernel launches, and the
    reprojection error of the tracks through the re-read .rpc_adj files."""
    import glob
    import os
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from sat_bundleadjust_tpu_torch import cli
    from sat_bundleadjust_tpu_torch.models.rpc import write_rpc_file

    with tempfile.TemporaryDirectory(prefix="slice_d_") as root:
        img_dir = os.path.join(root, "images")
        os.makedirs(img_dir)
        t0 = time.time()
        for k, im in enumerate(images):
            name = "20200413_1514{:02d}_view{}".format(10 + k, k)
            Image.fromarray(np.asarray(im.geotiff_path)).save(os.path.join(img_dir, name + ".tif"))
            write_rpc_file(im.rpc, os.path.join(img_dir, name + ".rpc"))
        write_s = time.time() - t0
        cfg = dict(SLICE_D_CONFIG, geotiff_dir=img_dir, rpc_dir=img_dir,
                   output_dir=os.path.join(root, "out"))
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        log("slice D: {} frames of {}x{} px written as .tif and their biased RPCs as .rpc in "
            "{:.2f} s; route: cli.main([config, '--verbose']) with {}".format(
                len(images), SLICE_C["h"], SLICE_C["w"], write_s, SLICE_D_CONFIG))

        for k in counters:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        scene = cli.main([cfg_path, "--verbose"])
        torch.cuda.synchronize()
        cli_s = time.time() - t0
        launches = {k.__name__: k.launches for k in counters}

        pipe = scene.ba_pipeline
        ba_dir = os.path.join(cfg["output_dir"], "ba_bruteforce")
        adj = sorted(glob.glob(os.path.join(ba_dir, "rpcs_adj", "*.rpc_adj")))
        caches = {d: len(os.listdir(os.path.join(ba_dir, "matches", d)))
                  for d in ("features", "features_utm", "pairwise_matches")}
        t0 = time.time()
        err_before, err_after = scene.compute_reprojection_error_before_and_after_bundle_adjust()
        reread_s = time.time() - t0
        n_ply = sum(1 for _ in open(os.path.join(ba_dir, "pts3d_adj.ply"))) - 7

    stages = dict(scene.timing)
    stages.update(pipe.timing)
    order = ["scene_load_s", "footprints_s", "cameras_s", "tracks_s", "triangulation_s",
             "selection_s", "soft_l1_s", "outliers_s", "l2_s", "refit_s", "writes_s"]
    matvecs = sum(r["matvecs"] for r in pipe.ba_rounds)
    refit = pipe.refit_stats
    log("slice D stage walls: " + "; ".join("{} {:.3f} s".format(k[:-2], stages[k]) for k in order)
        + "; CLI total {:.3f} s".format(cli_s))
    log("slice D tracks front end: " + "; ".join(
        "{} {:.3f} s".format(k[:-2], v) for k, v in pipe.ft_timing.items()))
    log("slice D: {} tracks, {} observations; LM rounds {}; mean reprojection {:.4f} -> "
        "{:.4f} px (solver); refit: {} rounds, margins {}, fit error per camera max {} / "
        "median {} px; kernel launches {} ({} matvecs); caches {}".format(
            pipe.ba_params.n_pts, pipe.ba_params.n_obs,
            [(r["iterations"], r["matvecs"]) for r in pipe.ba_rounds],
            float(np.mean(pipe.init_e)), float(np.mean(pipe.ba_e)), refit["rounds"],
            refit["margins"], ["{:.3g}".format(e) for e in refit["fit_error_max"]],
            ["{:.3g}".format(e) for e in refit["fit_error_median"]], launches, matvecs, caches))
    log("slice D re-read .rpc_adj: reprojection error of the tracks {:.4f} -> {:.4f} px "
        "({:.2f} s)".format(err_before, err_after, reread_s))
    assert len(adj) == len(images), adj
    assert n_ply == pipe.ba_params.n_pts, n_ply
    n = len(images)
    assert caches == {"features": n, "features_utm": n, "pairwise_matches": n * (n - 1) // 2}, caches
    assert launches["nn2_batched_i8"] > 0, launches
    assert launches["nn2_batched"] == 0 and launches["nn2_single"] == 0, launches
    assert launches["schur_wz"] == matvecs > 0, (launches, matvecs)
    assert launches["blur"] > 0 and launches["upsample2"] > 0, launches
    assert max(refit["fit_error_max"]) < 1e-3, refit
    assert err_before > SLICE_C_REPROJ_BEFORE_MIN, err_before
    assert err_after < SLICE_C_REPROJ_AFTER_MAX, err_after
    return {"write_s": write_s, "cli_s": cli_s, "stages_s": {k: stages[k] for k in order},
            "tracks_front_end_s": dict(pipe.ft_timing), "ba_rounds": pipe.ba_rounds,
            "refit": refit, "launches": launches, "matvecs": matvecs, "tracks": pipe.ba_params.n_pts,
            "reproj_before": err_before, "reproj_after": err_after, "rpc_adj_files": len(adj)}


def render_scene_e(dev, img_dir):
    """Slice E's frames, written to img_dir as .tif with their biased RPCs
    as .rpc: for each date d and view k a satellite pinhole
    off_nadir_m off nadir at azimuth k * 90 + d * 29 deg, the RPC fitted
    to it (demo.pinhole_rpc), the view rendered through that RPC by slice
    C's renderer; names YYYYMMDD_HHMMSS_viewK, dates a week apart. Returns
    the seconds taken."""
    import os

    import numpy as np
    from PIL import Image

    from sat_bundleadjust_tpu_torch.models.rpc import write_rpc_file
    from sat_bundleadjust_tpu_torch.utils import demo

    e = SLICE_E
    t0 = time.time()
    rpcs, names = [], []
    for d in range(e["dates"]):
        for k in range(e["views"]):
            a = 2 * np.pi * k / e["views"] + 0.5 * d
            P = demo.satellite_pinhole(view=(e["off_nadir_m"] * np.cos(a),
                                             e["off_nadir_m"] * np.sin(a)),
                                       gsd=e["gsd"], img_halfsize=(e["w"] / 2, e["h"] / 2))
            rpcs.append(demo.pinhole_rpc(P))
            names.append("202004{:02d}_1514{:02d}_view{}".format(13 + 7 * d, 10 + k,
                                                                 e["views"] * d + k))
    ims, _ = demo.render_synthetic_images(h=e["h"], w=e["w"], seed=0, alt=e["alt"],
                                          n_tex=e["n_tex"], tex_octaves=e["tex_octaves"],
                                          device=dev, rpcs=rpcs)
    rng = np.random.RandomState(2)
    for i, (im, rpc, name) in enumerate(zip(ims, rpcs, names)):
        bias = np.zeros(2) if i == 0 else rng.uniform(-e["bias_px"], e["bias_px"], 2)
        Image.fromarray((im * 255).astype(np.uint8)).save(os.path.join(img_dir, name + ".tif"))
        write_rpc_file(rpc._replace(col_offset=rpc.col_offset + bias[0],
                                    row_offset=rpc.row_offset + bias[1]),
                       os.path.join(img_dir, name + ".rpc"))
    return time.time() - t0


def run_cli(root, img_dir, name, counters, **config):
    """cli.main([config, "--verbose"]) in process, the counters set to 0
    just before and read just after. Returns (scene, wall s, launches,
    the ba_method directory)."""
    import os

    import torch

    from sat_bundleadjust_tpu_torch import cli

    cfg = dict(config, geotiff_dir=img_dir, rpc_dir=img_dir,
               output_dir=os.path.join(root, "out_" + name))
    cfg_path = os.path.join(root, "config_{}.json".format(name))
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    scene = cli.main([cfg_path, "--verbose"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k.__name__: k.launches for k in counters}
    return scene, wall, launches, os.path.join(cfg["output_dir"], cfg.get("ba_method",
                                                                         "ba_bruteforce"))


def stage_line(stages):
    order = ["scene_load_s", "footprints_s", "cameras_s", "tracks_s", "triangulation_s",
             "selection_s", "soft_l1_s", "outliers_s", "l2_s", "refit_s", "writes_s"]
    return "; ".join("{} {:.3f} s".format(k[:-2], stages[k]) for k in order if k in stages)


def slice_e(dev, counters, root, img_dir):
    """The time series through the CLI: ba_sequential, then ba_global."""
    import glob
    import os

    e = SLICE_E
    n_img = e["dates"] * e["views"]
    out = {}
    for mode in ("ba_sequential", "ba_global"):
        scene, wall, launches, ba_dir = run_cli(root, img_dir, mode, counters,
                                                ba_method=mode, **SLICE_E_CONFIG)
        adj = glob.glob(os.path.join(ba_dir, "rpcs_adj", "*.rpc_adj"))
        if mode == "ba_sequential":
            st = scene.date_stats
            rounds = [r for date in st["ba_rounds"] for r in date]
            before, after = st["init_e"], st["reproj_after"]
            for d, (stages, ft) in enumerate(zip(st["timing"], st["ft_timing"])):
                log("slice E {} date {} (n_adj {}): {}; tracks front end {}".format(
                    mode, d + 1, st["n_adj"][d], stage_line(stages), "; ".join(
                        "{} {:.3f} s".format(k[:-2], v) for k, v in ft.items())))
            assert st["n_adj"] == [0] + [e["views"]] * (e["dates"] - 1), st["n_adj"]
            n_ply = len(glob.glob(os.path.join(ba_dir, "pts3d_adj", "*_pts3d_adj.ply")))
            assert n_ply == e["dates"], n_ply
        else:
            pipe = scene.ba_pipeline
            rounds = pipe.ba_rounds
            b, a = scene.compute_reprojection_error_before_and_after_bundle_adjust()
            before, after = [b], [a]
            stages = dict(scene.timing)
            stages.update(pipe.timing)
            log("slice E {}: {}; tracks front end {}".format(mode, stage_line(stages), "; ".join(
                "{} {:.3f} s".format(k[:-2], v) for k, v in pipe.ft_timing.items())))
        matvecs = sum(r["matvecs"] for r in rounds)
        log("slice E {}: CLI {:.3f} s; {} .rpc_adj; reprojection through the re-read .rpc_adj "
            "{} -> {} px; LM rounds {}; kernel launches {} ({} matvecs)".format(
                mode, wall, len(adj), ["{:.4f}".format(v) for v in before],
                ["{:.4f}".format(v) for v in after],
                [(r["iterations"], r["matvecs"]) for r in rounds], launches, matvecs))
        assert len(adj) == n_img, len(adj)
        assert launches["nn2_batched_i8"] > 0, launches
        assert launches["nn2_batched"] == 0 and launches["nn2_single"] == 0, launches
        assert launches["schur_wz"] == matvecs > 0, (launches, matvecs)
        assert min(before) > SLICE_C_REPROJ_BEFORE_MIN, before
        assert max(after) < SLICE_C_REPROJ_AFTER_MAX, after
        out[mode] = {"cli_s": wall, "launches": launches, "matvecs": matvecs,
                     "reproj_before": before, "reproj_after": after,
                     "rounds": [(r["iterations"], r["matvecs"]) for r in rounds],
                     "n_adj": scene.date_stats["n_adj"] if mode == "ba_sequential" else [0]}
    return out


def matrix_solves(tag, cam_model, size, dev, counters, kernels):
    """A matrix-model scene (demo.make_matrix_scene, 0.05 px noise) with
    R, T, K and COMMON_K, solved on the card with the kernel as the CG
    operator (the main path; counted) and then with its plain version."""
    import numpy as np
    import torch

    from sat_bundleadjust_tpu_torch.ba.params import BAParams
    from sat_bundleadjust_tpu_torch.ba.solver import BASolver
    from sat_bundleadjust_tpu_torch.ops import lm
    from sat_bundleadjust_tpu_torch.utils import demo

    t0 = time.time()
    s = demo.make_matrix_scene(cam_model, n_views=8, noise_px=0.05, seed=0, **size)
    p = BAParams.from_obs_table(s["pts_ind"], s["cam_ind"], s["pts2d"], s["pts0"],
                                s["cameras_init"], cam_model, s["camera_centers"], [],
                                {"verbose": False, "correction_params": SLICE_F_PARAMS})
    solver = BASolver(p, device=dev)
    torch.cuda.synchronize()
    log("slice F {}: {} cams, {} tracks, {} obs, P = {} ({} of K, COMMON_K), set-up {:.2f} s".format(
        tag, p.n_cam, p.n_pts, p.n_obs, p.n_params, p.n_params_k, time.time() - t0))
    kernels["F " + tag] = check_schur_wz("slice F " + tag, p, solver)
    ls = {"max_iter": SLICE_F_MAX_ITER}
    for k in counters:
        k.launches = 0
    cam, pts, e1, rec = solve_round(solver, ls, "slice F {} L2, kernel".format(tag))
    launches = {k.__name__: k.launches for k in counters}
    graphs = graphs_against_eager("slice F {} L2".format(tag), solver, ls, (cam, pts, rec))
    # the same solve with the plain operator: the solver's config with
    # matvec "plain"
    t0 = time.time()
    cfg = solver.config(ls)._replace(matvec="plain")
    _, _, info_p = lm.solve(solver.residual_fn, solver.jac_fn,
                            torch.as_tensor(p.opt_block(), device=dev),
                            torch.as_tensor(p.pts3d, device=dev), solver.prob, cfg)
    e1_p = info_p["err_fin"]
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    k0 = p.n_params - p.n_params_k
    K = cam[:, k0:p.n_params].cpu().numpy()
    spread = float(np.abs(K - K[0]).max() / np.abs(K[0]).max())
    gap = abs(float(np.mean(e1)) - float(np.mean(e1_p)))
    log("slice F {}: plain operator {} LM iterations in {:.3f} s to {:.5f} px (kernel {:.5f}: "
        "gap {:.2e} px); optimized cameras' K spread {:.2e} relative; kernel launches {}".format(
            tag, info_p["iterations"], plain_s, float(np.mean(e1_p)), float(np.mean(e1)), gap,
            spread, launches))
    assert launches["schur_wz"] == rec["matvecs"] > 0, launches
    assert rec["reproj_before_mean"] > SLICE_F_REPROJ_BEFORE_MIN, rec["reproj_before_mean"]
    assert rec["reproj_after_mean"] < SLICE_F_REPROJ_AFTER_MAX, rec["reproj_after_mean"]
    assert gap <= 1e-3, gap
    assert spread <= 1e-9, spread
    return {"P": p.n_params, "kernel": rec, "graphs": graphs,
            "plain": {"iterations": info_p["iterations"],
            "wall_s": plain_s, "reproj_after_mean": float(np.mean(e1_p))},
            "gap_px": gap, "k_spread": spread, "launches": launches}


def slice_f(dev, counters, kernels, root, img_dir):
    """The matrix camera models: the BA stage at P = 11 and P = 8, then the
    CLI with perspective cameras on slice E's first date."""
    import glob
    import os

    out = {"perspective": matrix_solves("perspective", "perspective", SLICE_F_PERSPECTIVE, dev,
                                        counters, kernels),
           "affine": matrix_solves("affine", "affine", SLICE_F_AFFINE, dev, counters, kernels)}
    scene, wall, launches, ba_dir = run_cli(
        root, img_dir, "perspective", counters, cam_model="perspective",
        correction_params=SLICE_F_PARAMS, timeline_indices=[0], **SLICE_D_CONFIG)
    pipe = scene.ba_pipeline
    # the JAX package's run writes P_adj/ only; P_init/ is a method of the
    # pipeline that neither package's run calls
    pipe.save_initial_matrices()
    files = {d: len(glob.glob(os.path.join(ba_dir, d, "*"))) for d in ("P_init", "P_adj", "rpcs_adj")}
    before, after = scene.compute_reprojection_error_before_and_after_bundle_adjust()
    matvecs = sum(r["matvecs"] for r in pipe.ba_rounds)
    stages = dict(scene.timing)
    stages.update(pipe.timing)
    log("slice F CLI (perspective, {}, date 1): {}; CLI {:.3f} s; files {}; P = {}; reprojection "
        "through the re-read .rpc_adj {:.4f} -> {:.4f} px; refit fit error max {} px; LM rounds "
        "{}; kernel launches {} ({} matvecs)".format(
            SLICE_F_PARAMS, stage_line(stages), wall, files, pipe.ba_params.n_params, before,
            after, ["{:.3g}".format(v) for v in pipe.refit_stats["fit_error_max"]],
            [(r["iterations"], r["matvecs"]) for r in pipe.ba_rounds], launches, matvecs))
    n = SLICE_E["views"]
    assert files == {"P_init": n, "P_adj": n, "rpcs_adj": n}, files
    assert launches["nn2_batched_i8"] > 0, launches
    assert launches["nn2_batched"] == 0 and launches["nn2_single"] == 0, launches
    assert launches["schur_wz"] == matvecs > 0, (launches, matvecs)
    assert before > SLICE_C_REPROJ_BEFORE_MIN, before
    assert after < SLICE_C_REPROJ_AFTER_MAX, after
    out["cli"] = {"cli_s": wall, "stages_s": stages, "launches": launches, "matvecs": matvecs,
                  "reproj_before": before, "reproj_after": after, "files": files,
                  "fit_error_max": pipe.refit_stats["fit_error_max"]}
    return out


def slice_g_inputs(root, img_dir):
    """Slice G's AOI (the central half, by area, of view 0's footprint at
    the terrain's altitude) and DEM, written under root. Returns their
    paths and the plane's value at (lon, lat) from its formula."""
    import glob
    import os

    import numpy as np

    from sat_bundleadjust_tpu_torch.models.rpc import rpc_from_rpc_file, rpc_localization_np
    from sat_bundleadjust_tpu_torch.utils import geo, tiffwrite
    from sat_bundleadjust_tpu_torch.utils.io import save_geojson

    e, d = SLICE_E, SLICE_G_DEM
    rpc = rpc_from_rpc_file(sorted(glob.glob(os.path.join(img_dir, "*.rpc")))[0])
    lon, lat = rpc_localization_np(rpc, np.array([0.0, e["w"], e["w"], 0.0]),
                                   np.array([0.0, 0.0, e["h"], e["h"]]), np.full(4, e["alt"]))
    c = np.array([lon.mean(), lat.mean()])
    aoi_path = os.path.join(root, "slice_g_aoi.json")
    save_geojson(aoi_path, geo.geojson_polygon(c + (np.stack([lon, lat], 1) - c) * np.sqrt(0.5)))

    east, north = geo.utm_from_lonlat(c[:1], c[1:])
    bbx = {"xmin": float(east[0]) - d["half"], "xmax": float(east[0]) + d["half"],
           "ymin": float(north[0]) - d["half"], "ymax": float(north[0]) + d["half"]}
    h, w = geo.utm_bbox_shape(bbx, d["res"])
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    a, b, cr = d["plane"]
    z = a + b * jj + cr * ii
    assert np.array_equal(z.astype(np.float32), z), "the DEM's nodes must be exact in float32"
    dem_path = os.path.join(root, "slice_g_dem.tif")
    tiffwrite.write_georeferenced_raster_utm_bbox(
        dem_path, z.astype(np.float32), bbx,
        geo.epsg_code_from_utm_zone(geo.zonestring_from_lonlat(c[0], c[1])), d["res"])

    def plane_at(lon, lat):
        ee, nn = geo.utm_from_lonlat(np.atleast_1d(lon), np.atleast_1d(lat))
        return a + b * (ee - bbx["xmin"]) / d["res"] + cr * (bbx["ymax"] - nn) / d["res"]

    return aoi_path, dem_path, plane_at


class LargestI8Call:
    """While entered, keeps the operands of the largest call (B * n1 * n2)
    that ops/match makes of the int8 2-NN kernel's wrapper, from the staged
    matcher's chunks or the batched matcher's host-packed ones: ops/match
    reaches the wrapper through a stand-in for its nn2_match module, which
    passes every call on to the wrapper, and the wrapper counts its
    launches."""

    def __enter__(self):
        from sat_bundleadjust_tpu_torch.ops import match as match_ops

        self.module, self.real, self.args = match_ops, match_ops.nn2_match, None
        outer = self

        class Observed:
            def __getattr__(self, name):
                return getattr(outer.real, name)

            def nn2_batched_i8(self, *args):
                work = lambda a: a[0].shape[0] * a[0].shape[1] * a[1].shape[1]  # noqa: E731
                if outer.args is None or work(args) > work(outer.args):
                    outer.args = args
                return outer.real.nn2_batched_i8(*args)

        match_ops.nn2_match = Observed()
        return self

    def __exit__(self, *exc):
        self.module.nn2_match = self.real


def keypoints_inside(features, mask, backend):
    """Which keypoints lie inside the mask, by the detector's own pixel
    rule: cv2 tests the pixel of the rounded position (its
    KeyPointsFilter::runByPixelsMask), the package's SIFT that of the
    truncated one (tracks/detection._apply_mask)."""
    import numpy as np

    xy = features[~np.isnan(features[:, 0]), :2]
    px = (xy + 0.5 if backend == "opencv" else xy).astype(np.int64)
    px[:, 0] = np.clip(px[:, 0], 0, mask.shape[1] - 1)
    px[:, 1] = np.clip(px[:, 1], 0, mask.shape[0] - 1)
    return mask[px[:, 1], px[:, 0]] > 0


def keypoints_without_masks(paths, backend, dev):
    """Keypoints per image of the same detector without the masks, capped
    at FT_kp_max as the run caps them."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from sat_bundleadjust_tpu_torch.ops.sift import detect_sift_batch
    from sat_bundleadjust_tpu_torch.tracks.detection import detect_opencv
    from sat_bundleadjust_tpu_torch.utils.io import load_image

    kp_max = SLICE_D_CONFIG["FT_kp_max"]
    if backend == "opencv":
        with ThreadPoolExecutor(max_workers=4) as pool:
            feats = list(pool.map(lambda p: detect_opencv(load_image(p, equalize=True)), paths))
    else:
        feats = detect_sift_batch([load_image(p).astype(np.float32) for p in paths],
                                  max_kp=kp_max, device=dev)
    return [min(f.shape[0], kp_max) for f in feats]


def slice_g(dev, counters, root, img_dir):
    """The CLI with the AOI masks and the DEM, with the opencv detector
    (G1) and the package's SIFT (G2), on slice E's first date."""
    import glob
    import os

    import numpy as np
    import torch

    from sat_bundleadjust_tpu_torch.ops import nn2_match as nm
    from sat_bundleadjust_tpu_torch.pipeline import default_altitude
    from sat_bundleadjust_tpu_torch.utils.io import get_id

    import cv2  # G1's detector: a machine without it fails here

    log("slice G: cv2 {}; AOI the central half of the scene, DEM a plane {} (m, per node of "
        "{} m)".format(cv2.__version__, SLICE_G_DEM["plane"], SLICE_G_DEM["res"]))
    aoi_path, dem_path, plane_at = slice_g_inputs(root, img_dir)
    frames = sorted(glob.glob(os.path.join(img_dir, "*.tif")))[:SLICE_E["views"]]
    out = {}
    for tag, cfg in SLICE_G_RUNS.items():
        backend = cfg.get("FT_sift_detection", "tpu")
        with LargestI8Call() as largest:
            scene, wall, launches, ba_dir = run_cli(root, img_dir, tag, counters,
                                                    aoi_geojson=aoi_path, dem_path=dem_path,
                                                    timeline_indices=[0], **cfg)
        pipe = scene.ba_pipeline
        adj = glob.glob(os.path.join(ba_dir, "rpcs_adj", "*.rpc_adj"))
        before, after = scene.compute_reprojection_error_before_and_after_bundle_adjust()
        matvecs = sum(r["matvecs"] for r in pipe.ba_rounds)
        kept, inside, share = [], [], []
        for im in pipe.images:
            iid = get_id(im.geotiff_path)
            f = np.load(os.path.join(ba_dir, "matches", "features", iid + ".npy"))
            m = np.load(os.path.join(ba_dir, "matches", "masks", iid + ".npy"))
            ins = keypoints_inside(f, m, backend)
            kept.append(int(ins.size))
            inside.append(int(ins.sum()))
            share.append(float(m.mean()))
        alts = [(float(im.alt), float(plane_at(float(np.asarray(im.rpc.lon_offset)),
                                                float(np.asarray(im.rpc.lat_offset)))[0]),
                 default_altitude(im.rpc)) for im in pipe.images]
        alt_err = max(abs(a - p) for a, p, _ in alts)
        t0 = time.time()
        unmasked = keypoints_without_masks(frames, backend, dev)
        unmasked_s = time.time() - t0

        # after the counters were read: the int8 kernel against its plain
        # version at the run's largest chunk
        args = largest.args
        a = nm.nn2_batched_i8(*args)
        plain = nm.nn2_plain(*args)
        torch.cuda.synchronize()
        gate = "off" if bool((args[6] >= 1e9).all()) else "on"
        ms = cuda_ms(lambda: nm.nn2_batched_i8(*args), 20)
        plain_ms = cuda_ms(lambda: nm.nn2_plain(*args), 1, rounds=3)
        bound_ms, bound_by, ops, nbytes = nn2_bound(args[4], args[5], 128, PEAK_I8_TC_PER_S)

        stages = dict(scene.timing)
        stages.update(pipe.timing)
        log("slice G {} ({}, {}): {}; tracks front end {}".format(
            tag, backend, cfg.get("FT_sift_matching", "epipolar_based"), stage_line(stages),
            "; ".join("{} {:.3f} s".format(k[:-2], v) for k, v in pipe.ft_timing.items())))
        log("slice G {}: CLI {:.3f} s; {} .rpc_adj; reprojection through the re-read .rpc_adj "
            "{:.4f} -> {:.4f} px; keypoints per image without the masks {} ({:.2f} s), kept {}, "
            "inside their masks {}; mask shares {}; footprint altitudes {} m (plane {}, RPC offset "
            "{}), max error {:.3g} m; LM rounds {}; kernel launches {} ({} matvecs)".format(
                tag, wall, len(adj), before, after, unmasked, unmasked_s, kept, inside,
                ["{:.3f}".format(v) for v in share], ["{:.6f}".format(v[0]) for v in alts],
                ["{:.6f}".format(v[1]) for v in alts], [v[2] for v in alts], alt_err,
                [(r["iterations"], r["matvecs"]) for r in pipe.ba_rounds], launches, matvecs))
        log("slice G {}: int8 2-NN at the largest chunk (gate {}, B={} n1={} n2={}): bit-identical "
            "to plain; kernel {:.4f} ms ({:.1f} TOP/s, {:.1%} of the bound), plain {:.4f} ms, bound "
            "{:.4f} ms ({})".format(tag, gate, args[0].shape[0], args[0].shape[1],
                                    args[1].shape[1], ms, ops / ms / 1e9, bound_ms / ms, plain_ms,
                                    bound_ms, bound_by))
        assert torch.equal(a, plain), "nn2_batched_i8 differs from its plain version"
        assert gate == ("off" if backend == "opencv" else "on"), gate
        assert len(adj) == SLICE_E["views"], adj
        assert inside == kept and min(kept) > 0, (inside, kept)
        assert all(SLICE_G_MASK_SHARE[0] < v < SLICE_G_MASK_SHARE[1] for v in share), share
        assert alt_err < SLICE_G_ALT_TOL_M, alts
        assert all(abs(p - d) > 0.1 for _, p, d in alts), alts
        assert launches["nn2_batched_i8"] > 0, launches
        assert launches["nn2_batched"] == 0 and launches["nn2_single"] == 0, launches
        assert launches["schur_wz"] == matvecs > 0, (launches, matvecs)
        assert before > SLICE_C_REPROJ_BEFORE_MIN, before
        assert after < SLICE_C_REPROJ_AFTER_MAX, after
        out[tag] = {"cli_s": wall, "stages_s": stages, "tracks_front_end_s": dict(pipe.ft_timing),
                    "launches": launches, "matvecs": matvecs, "reproj_before": before,
                    "reproj_after": after, "keypoints_without_masks": unmasked,
                    "keypoints_kept": kept, "mask_shares": share, "footprint_alts": alts,
                    "i8_largest_chunk": {"gate": gate, "B": args[0].shape[0],
                                         "n1": args[0].shape[1], "n2": args[1].shape[1],
                                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                         "bound_by": bound_by}}
    return out


def spawn_ranks(phase, world, args, timeout):
    """Run `python3 chip_smoke.py --rank phase <rank> <world> <port> *args`
    for every rank (each writes to its own log file) and wait for them:
    when a rank fails or the deadline passes, the others are killed and the
    run fails. Returns the ranks' outputs."""
    import os
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        log_f = tempfile.TemporaryFile("w+")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", phase, str(r), str(world),
             str(port), *map(str, args)], stdout=log_f, stderr=subprocess.STDOUT, text=True),
            log_f))
    deadline = time.time() + timeout
    failed = None
    try:
        while any(p.poll() is None for p, _ in procs):
            bad = [r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = "rank {} exited with {}".format(bad[0], procs[bad[0]][0].returncode)
                break
            if time.time() > deadline:
                failed = "ranks still running after {} s".format(timeout)
                break
            time.sleep(0.2)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
        outs = []
        for p, log_f in procs:
            p.wait()
            log_f.seek(0)
            outs.append(log_f.read())
            log_f.close()
    for r, out in enumerate(outs):
        for line in out.splitlines()[-6:]:
            log("  [{} rank {}] {}".format(phase, r, line[:300]))
    if failed is None and any(p.returncode != 0 for p, _ in procs):
        failed = "a rank exited with {}".format([p.returncode for p, _ in procs])
    assert failed is None, "{}: {}\n{}".format(phase, failed, "\n".join(
        "--- rank {} ---\n{}".format(r, out[-6000:]) for r, out in enumerate(outs)))
    return outs


def shard_schur_check(solver):
    """The shard's Schur operator (SchurOperator, the kernels) against
    schur_wz_plain on the shard's own operands at its first LM step, as
    check_schur_wz does, and its times per call (CUDA events). No
    collective: one rank runs it alone."""
    import torch

    from sat_bundleadjust_tpu_torch.ops import lm
    from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv

    p, prob = solver.p, solver.prob
    dev = solver.mesh.device
    cam0 = torch.as_tensor(p.opt_block(), device=dev)
    pts0 = torch.as_tensor(p.pts3d, device=dev)
    r, J_cam, J_pt = solver.local_jacobians(cam0, pts0)
    cfg = lm.LMConfig(schur_mode="cg")
    _, g_cam, g_pt, _, V, W = lm._normal_blocks(r, J_cam, J_pt, prob, p.n_cam, solver.n_loc, cfg)
    Vinv = lm._inv3x3(lm._damp(V, 1e-4))
    scale = lm._schur_rhs(g_cam, g_pt, W, Vinv, prob, p.n_cam).abs().max()
    W_pt, W_cm = lm.fold_layouts((W / torch.sqrt(scale)).float(), Vinv.float(), prob)
    args = (W_pt, prob.cam_ind_pt, W_cm, prob.pts_ind_cam)
    x = torch.randn(p.n_cam, p.n_params, dtype=torch.float32, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    op = smv.SchurOperator(*args)
    wz = op(x).clone()
    plain = smv.schur_wz_plain(x, *args)
    torch.cuda.synchronize()
    scale = float(plain.abs().max())
    err = float((wz - plain).abs().max())
    assert bool(torch.isfinite(wz).all()) and err <= 2e-6 * scale, (err, scale)
    k_shard = int((solver.obs["weights"] > 0).sum())
    return {"K": k_shard, "L": solver.n_loc, "Tp": int(W_pt.shape[1]), "Tc": int(W_cm.shape[1]),
            "max_abs_err": err, "rel_err": err / scale, "op_wall_ms": cuda_ms(lambda: op(x), 100),
            "plain_ms": cuda_ms(lambda: smv.schur_wz_plain(x, *args), 5, rounds=3)}


def h1_rank(rank, world, port, backend, out_dir):
    """One rank of H1: slice B's problem solved over the ranks."""
    import os

    import numpy as np
    import torch

    from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv
    from sat_bundleadjust_tpu_torch.parallel import multihost
    from sat_bundleadjust_tpu_torch.parallel.dist_solver import (
        make_distributed_solver,
        run_distributed_ba,
    )
    from sat_bundleadjust_tpu_torch.parallel.mesh import make_mesh
    from sat_bundleadjust_tpu_torch.utils import demo

    multihost.initialize("127.0.0.1:{}".format(port), int(world), int(rank), backend=backend)
    dev = torch.device("cuda")
    t0 = time.time()
    scene = demo.make_scene_arrays(n_cam=1000, n_pts=200000, seed=0, device=dev)
    p = demo.scene_to_baparams(scene)
    solver = make_distributed_solver(p, mesh=make_mesh(), time_collectives=True)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    obs_index = solver.obs_index
    plan = {"obs_per_shard": [int(v) for v in (obs_index >= 0).sum(axis=1)],
            "K_pad": int(obs_index.shape[1])}
    tracks = torch.tensor([int((solver.obs["track_global"] < p.n_pts).sum())], device=dev)
    if world > 1:
        parts = [torch.empty_like(tracks) for _ in range(int(world))]
        torch.distributed.all_gather(parts, tracks)
        tracks = torch.cat(parts)
    plan["tracks_per_shard"] = tracks.tolist()
    shard = shard_schur_check(solver) if int(rank) == 0 else None
    # warm-up (first calls into cuBLAS and cuSOLVER), then the timed run
    run_distributed_ba(p, {"max_iter": 1}, solver=solver)
    smv.schur_wz.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    _, (cam, _), info = run_distributed_ba(p, {"max_iter": SLICE_B_MAX_ITER}, solver=solver)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = smv.schur_wz.launches
    its = info["iterations"]
    op_reduces = info["allreduces"] - 7 * its - 1
    rec = {"rank": int(rank), "backend": backend, "world": int(world), "setup_s": setup_s,
           "plan": plan, "iterations": its, "cg_iterations": info["cg_iterations"],
           "matvecs": info["matvecs"], "allreduces": info["allreduces"],
           "allreduces_per_cg_iteration": op_reduces / max(info["cg_iterations"], 1),
           "wall_s": wall, "wall_per_lm_iteration_s": wall / max(its, 1),
           "collective_s": info["collective_s"], "collective_share": info["collective_s"] / wall,
           "reproj_before_mean": float(np.mean(info["err0"])),
           "reproj_after_mean": float(np.mean(info["err_fin"])), "schur_wz_launches": launches,
           "shard_schur": shard}
    np.save(os.path.join(out_dir, "h1_{}_{}_{}_cam.npy".format(backend, world, rank)),
            cam.cpu().numpy())
    with open(os.path.join(out_dir, "h1_{}_{}_{}.json".format(backend, world, rank)), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def h2_rank(rank, world, port, cfg_path, out_dir):
    """One rank of H2: the CLI with "distributed": true (its own log file),
    with the images it detects and its writes counted."""
    import os

    import torch

    from sat_bundleadjust_tpu_torch import cli
    from sat_bundleadjust_tpu_torch.ops import nn2_match as nm
    from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv
    from sat_bundleadjust_tpu_torch.ops import sift
    from sat_bundleadjust_tpu_torch.ops import triangulate as ttri
    from sat_bundleadjust_tpu_torch.parallel import multihost
    from sat_bundleadjust_tpu_torch.pipeline import BundleAdjustmentPipeline

    # two ranks share the card: gloo (NCCL takes one rank per device); the
    # CLI's own initialize() then finds no SATBA_* variable and leaves it
    multihost.initialize("127.0.0.1:{}".format(port), int(world), int(rank), backend="gloo")
    seen = {"images": 0, "writes": 0}
    detect, save = sift.detect_sift_batch, BundleAdjustmentPipeline.save_corrected_cameras

    def counted_detect(images, *args, **kwargs):
        seen["images"] += len(images)
        return detect(images, *args, **kwargs)

    def counted_save(self):
        seen["writes"] += 1
        return save(self)

    sift.detect_sift_batch = counted_detect
    BundleAdjustmentPipeline.save_corrected_cameras = counted_save
    counters = [nm.nn2_batched_i8, nm.nn2_batched, nm.nn2_single, smv.schur_wz, sift.blur,
                sift.upsample2, ttri.rpc_triangulate]
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    scene = cli.main([cfg_path])
    torch.cuda.synchronize()
    wall = time.time() - t0
    pipe = scene.ba_pipeline
    before, after = scene.compute_reprojection_error_before_and_after_bundle_adjust()
    rec = {"rank": int(rank), "cli_s": wall, "seen": seen,
           "launches": {k.__name__: k.launches for k in counters},
           "matvecs": sum(r["matvecs"] for r in pipe.ba_rounds),
           "distributed_rounds": ["allreduces" in r for r in pipe.ba_rounds],
           "rounds": [(r["iterations"], r["matvecs"], r["allreduces"]) for r in pipe.ba_rounds],
           "tracks": int(pipe.C.shape[1]), "reproj_before": before, "reproj_after": after,
           "stages_s": dict(pipe.timing)}
    with open(os.path.join(out_dir, "h2_{}.json".format(rank)), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def slice_h(dev, counters, root, img_dir, slice_b_reproj):
    """The distributed solve (H1) and the CLI across two ranks (H2), each
    rank a child process of this script."""
    import glob
    import os

    import numpy as np

    from sat_bundleadjust_tpu_torch.models.rpc import (
        rpc_from_rpc_file,
        rpc_localization_np,
        rpc_projection_np,
    )

    out_dir = os.path.join(root, "slice_h")
    os.makedirs(out_dir)
    out = {}
    for tag, backend, world in (("H1a", "nccl", 1), ("H1b", "gloo", 2)):
        t0 = time.time()
        spawn_ranks("h1", world, [backend, out_dir], SLICE_H_TIMEOUT_S)
        recs = []
        for r in range(world):
            with open(os.path.join(out_dir, "h1_{}_{}_{}.json".format(backend, world, r))) as f:
                recs.append(json.load(f))
        cams = [np.load(os.path.join(out_dir, "h1_{}_{}_{}_cam.npy".format(backend, world, r)))
                for r in range(world)]
        r0 = recs[0]
        sh = r0["shard_schur"]
        log("slice H {} ({} rank(s), {}): shards: observations {}, tracks {} (K_pad {}); "
            "{} LM iterations, {} CG iterations, {} matvecs, {:.3f} all-reduces per CG "
            "iteration ({} in all); wall {:.3f} s ({:.4f} s per LM iteration), collectives "
            "{:.3f} s ({:.1%} of the wall); reprojection {:.4f} -> {:.4f} px (slice B one "
            "device: {:.4f}); schur_wz launches per rank {}; set-up {:.2f} s; child processes "
            "{:.1f} s".format(
                tag, world, backend, r0["plan"]["obs_per_shard"], r0["plan"]["tracks_per_shard"],
                r0["plan"]["K_pad"], r0["iterations"], r0["cg_iterations"], r0["matvecs"],
                r0["allreduces_per_cg_iteration"], r0["allreduces"], r0["wall_s"],
                r0["wall_per_lm_iteration_s"], r0["collective_s"], r0["collective_share"],
                r0["reproj_before_mean"], r0["reproj_after_mean"], slice_b_reproj,
                [r["schur_wz_launches"] for r in recs], r0["setup_s"], time.time() - t0))
        log("slice H {}: shard 0's Schur operator (K {}, L {}, Tp {}, Tc {}) vs plain {:.2e} of "
            "max|wz|; {:.5f} ms per call through the bound operator, plain {:.4f} ms".format(
                tag, sh["K"], sh["L"], sh["Tp"], sh["Tc"], sh["rel_err"], sh["op_wall_ms"],
                sh["plain_ms"]))
        assert all(np.array_equal(c, cams[0]) for c in cams), "{}: the ranks' cam differ".format(tag)
        assert all(r["schur_wz_launches"] == r["matvecs"] > 0 for r in recs), recs
        assert all(r["iterations"] == r0["iterations"] for r in recs), recs
        assert abs(r0["reproj_after_mean"] - slice_b_reproj) <= SLICE_H_BAR_PX, (
            r0["reproj_after_mean"], slice_b_reproj)
        assert sum(r0["plan"]["obs_per_shard"]) == 800000, r0["plan"]
        out[tag] = {"ranks": recs}

    # H2: the one-process reference of slice E's first date, then the CLI
    # with "distributed": true across two ranks
    ref_scene, ref_wall, ref_launches, ref_dir = run_cli(root, img_dir, "h2_reference", counters,
                                                         timeline_indices=[0], **SLICE_D_CONFIG)
    cfg = dict(SLICE_D_CONFIG, timeline_indices=[0], distributed=True, geotiff_dir=img_dir,
               rpc_dir=img_dir, output_dir=os.path.join(root, "out_h2"))
    cfg_path = os.path.join(root, "config_h2.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    t0 = time.time()
    spawn_ranks("h2", 2, [cfg_path, out_dir], SLICE_H_TIMEOUT_S)
    wall = time.time() - t0
    recs = []
    for r in range(2):
        with open(os.path.join(out_dir, "h2_{}.json".format(r))) as f:
            recs.append(json.load(f))
    ba_dir = os.path.join(cfg["output_dir"], "ba_bruteforce")
    files = sorted(glob.glob(os.path.join(ba_dir, "rpcs_adj", "*.rpc_adj")))
    ref_files = sorted(glob.glob(os.path.join(ref_dir, "rpcs_adj", "*.rpc_adj")))
    logs = sorted(os.path.basename(f) for f in glob.glob(os.path.join(cfg["output_dir"], "*.log")))
    # the ground grid: a 9 x 9 grid of each image's pixels localized at the
    # terrain's altitude through the one-process file
    gap = 0.0
    cols, rows = np.meshgrid(np.linspace(0, SLICE_E["w"], 9), np.linspace(0, SLICE_E["h"], 9))
    alts = np.full(cols.size, SLICE_E["alt"])
    for fa, fb in zip(files, ref_files):
        a, b = rpc_from_rpc_file(fa), rpc_from_rpc_file(fb)
        lon, lat = rpc_localization_np(b, cols.ravel(), rows.ravel(), alts)
        pa = np.stack(rpc_projection_np(a, lon, lat, alts), axis=1)
        pb = np.stack(rpc_projection_np(b, lon, lat, alts), axis=1)
        gap = max(gap, float(np.abs(pa - pb).max()))
    launches = {k: sum(r["launches"][k] for r in recs) for k in recs[0]["launches"]}
    ref_before, ref_after = ref_scene.compute_reprojection_error_before_and_after_bundle_adjust()
    log("slice H H2 (CLI, 2 gloo ranks, slice E date 1): child processes {:.1f} s (CLI {} s per "
        "rank); images detected per rank {}, save_corrected_cameras per rank {}; logs {}; {} "
        ".rpc_adj; reprojection through the re-read .rpc_adj {:.4f} -> {:.4f} px (one process: "
        "{:.4f} -> {:.4f} px, CLI {:.3f} s); ground grid against the one-process files: max {:.2e} "
        "px; LM rounds per rank {}; kernel launches {} (per rank {}), matvecs per rank {}".format(
            wall, ["{:.2f}".format(r["cli_s"]) for r in recs], [r["seen"]["images"] for r in recs],
            [r["seen"]["writes"] for r in recs], logs, len(files), recs[0]["reproj_before"],
            recs[0]["reproj_after"], ref_before, ref_after, ref_wall, gap,
            [r["rounds"] for r in recs], launches, [r["launches"] for r in recs],
            [r["matvecs"] for r in recs]))
    n = SLICE_E["views"]
    assert [r["seen"]["images"] for r in recs] == [n // 2, n // 2], recs
    assert [r["seen"]["writes"] for r in recs] == [1, 0], recs
    assert logs == ["bundle_adjust.log", "bundle_adjust.p1.log"], logs
    assert all(r["distributed_rounds"] and all(r["distributed_rounds"]) for r in recs), recs
    assert len(files) == n and [os.path.basename(f) for f in files] == [
        os.path.basename(f) for f in ref_files], (files, ref_files)
    assert recs[0]["reproj_before"] > SLICE_C_REPROJ_BEFORE_MIN, recs[0]["reproj_before"]
    assert recs[0]["reproj_after"] < SLICE_H2_REPROJ_AFTER_MAX, recs[0]["reproj_after"]
    assert gap < SLICE_H2_GRID_PX, gap
    assert all(r["launches"]["nn2_batched_i8"] > 0 for r in recs), recs
    assert launches["nn2_batched"] == 0 and launches["nn2_single"] == 0, launches
    assert all(r["launches"]["schur_wz"] == r["matvecs"] > 0 for r in recs), recs
    out["H2"] = {"ranks": recs, "child_s": wall, "launches": launches, "grid_gap_px": gap,
                 "reference": {"cli_s": ref_wall, "launches": ref_launches,
                               "reproj_before": ref_before, "reproj_after": ref_after}}
    return out


def rank_main(argv):
    """A child process of slice H: `--rank h1|h2 <rank> <world> <port> ...`."""
    phase, rank, world, port, *rest = argv
    {"h1": h1_rank, "h2": h2_rank}[phase](int(rank), int(world), int(port), *rest)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the full record as JSON to this file")
    ap.add_argument("--rank", nargs="+", help=argparse.SUPPRESS)  # a child of slice H
    args = ap.parse_args()
    if args.rank:
        return rank_main(args.rank)
    t_start = time.time()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2

    import sat_bundleadjust_tpu_torch  # noqa: F401  (pins the precision flags)
    from sat_bundleadjust_tpu_torch.ops import _build
    from sat_bundleadjust_tpu_torch.ops import nn2_match as nm
    from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv
    from sat_bundleadjust_tpu_torch.ops import sift
    from sat_bundleadjust_tpu_torch.ops import triangulate as ttri

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
    build_logs = _build.build()
    build_s = time.time() - t0
    log("kernel build: {} in {:.2f} s (one nvcc per source, in parallel)".format(
        _build.sources(), build_s))
    ptxas = ptxas_summary(build_logs.get("nn2_match", ""))
    assert "nn2_i8_kernel" in ptxas, "no ptxas report of the int8 2-NN kernel"
    for kernel in ("nn2_tf32_columns", "nn2_tf32_kernel", "nn2_merge_splits"):
        assert kernel in ptxas, "no ptxas report of " + kernel
    # the Schur kernels at the P the main path runs: 3 (rpc R), 8 (affine
    # R T K), 11 (perspective R T K)
    ptxas.update((k, v) for k, v in ptxas_summary(build_logs.get("schur_matvec", "")).items()
                 if "<" not in k or k.endswith(("<3>", "<8>", "<11>")))
    for P in (3, 8, 11):
        for kernel in ("schur_points", "schur_cameras"):
            assert "{}<{}>".format(kernel, P) in ptxas, "no ptxas report of {}<{}>".format(kernel, P)
    # the SIFT kernels at the radii the main path runs: 5 (the first blur), 13
    ptxas.update((k, v) for k, v in ptxas_summary(build_logs.get("sift_blur", "")).items()
                 if "<" not in k or k.endswith(("<5>", "<13>")))
    for kernel in ("sift_blur_kernel<5>", "sift_blur_kernel<13>", "sift_upsample2_kernel"):
        assert kernel in ptxas, "no ptxas report of " + kernel
    ptxas.update(ptxas_summary(build_logs.get("rpc_triangulate", "")))
    assert "rpc_triangulate_kernel" in ptxas, "no ptxas report of rpc_triangulate_kernel"
    for name, line in ptxas.items():
        log("ptxas {}: {}".format(name, line))

    kernels = {"counters": [smv.schur_wz]}
    rec = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
           "build_s": build_s, "ptxas": ptxas}
    rec["slice_a"] = slice_a(dev, kernels)
    rec["slice_b"] = slice_b(dev, kernels)
    rec["small_reference"] = small_reference(dev)
    counters = [nm.nn2_batched_i8, nm.nn2_batched, nm.nn2_single, smv.schur_wz, sift.blur,
                sift.upsample2, ttri.rpc_triangulate]
    c = slice_c(dev, counters)
    rec["schur_wz"] = {"A": kernels["A"], "B": kernels["B"], "C": c["schur_wz"]}
    images, ft = c.pop("images"), c.pop("ft")
    rec["nn2"] = check_nn2(ft, images, dev)
    rec["detection_profile"] = profile_detection(images, dev)
    rec["slice_c"] = c
    rec["sift_device_check"] = sift_device_check(dev, images, ft, c)
    rec["sift_blur"] = check_sift_blur(dev)
    rec["rpc_triangulate"] = check_rpc_triangulate(dev)
    rec["slice_i"] = slice_i(dev, counters, images, ft)
    del ft
    rec["slice_d"] = slice_d(dev, counters, images)
    del images
    with tempfile.TemporaryDirectory(prefix="slice_e_") as root:
        img_dir = os.path.join(root, "images")
        os.makedirs(img_dir)
        render_s = render_scene_e(dev, img_dir)
        log("slice E: {} dates x {} views of {}x{} px rendered through pinhole-fitted RPCs and "
            "written in {:.2f} s".format(SLICE_E["dates"], SLICE_E["views"], SLICE_E["h"],
                                         SLICE_E["w"], render_s))
        rec["slice_e"] = slice_e(dev, counters, root, img_dir)
        rec["slice_f"] = slice_f(dev, counters, kernels, root, img_dir)
        rec["slice_g"] = slice_g(dev, counters, root, img_dir)
        rec["slice_h"] = slice_h(dev, counters, root, img_dir,
                                 rec["slice_b"]["l2"]["reproj_after_mean"])
    rec["slice_j"] = slice_j(dev, counters)
    rec["schur_wz"].update({"F perspective": kernels["F perspective"],
                            "F affine": kernels["F affine"]})
    rec["total_s"] = time.time() - t_start
    log("total {:.1f} s".format(rec["total_s"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1, default=str)

    b = kernels["B"]
    other = "; ".join(
        "slice {} (P = {}): ms (device) {:.5f}, op_wall_ms {:.5f}, wall_ms {:.5f}, plain_ms "
        "{:.5f}, bound_ms {:.5f}".format(k, r["shape"]["P"], r["device_ms"], r["op_wall_ms"],
                                         r["wall_ms"], r["plain_ms"], r["bound_ms"])
        for k, r in rec["schur_wz"].items() if k != "B")
    main_path = [rec["slice_a"]["launches"]["schur_wz"], rec["slice_b"]["launches"]["schur_wz"],
                 c["launches"]["schur_wz"], rec["slice_d"]["launches"]["schur_wz"],
                 rec["slice_e"]["ba_sequential"]["launches"]["schur_wz"],
                 rec["slice_e"]["ba_global"]["launches"]["schur_wz"],
                 rec["slice_f"]["perspective"]["launches"]["schur_wz"],
                 rec["slice_f"]["affine"]["launches"]["schur_wz"],
                 rec["slice_f"]["cli"]["launches"]["schur_wz"],
                 rec["slice_g"]["G1"]["launches"]["schur_wz"],
                 rec["slice_g"]["G2"]["launches"]["schur_wz"],
                 sum(r["schur_wz_launches"] for r in rec["slice_h"]["H1a"]["ranks"]),
                 sum(r["schur_wz_launches"] for r in rec["slice_h"]["H1b"]["ranks"]),
                 rec["slice_h"]["H2"]["reference"]["launches"]["schur_wz"],
                 rec["slice_h"]["H2"]["launches"]["schur_wz"],
                 rec["slice_j"]["ba"]["main_path_schur_wz"]]
    entries = [{
        "name": "schur_wz", "route": "cuda",
        "source": "sat_bundleadjust_tpu_torch/csrc/schur_matvec.cu",
        "replaces": "sat_bundleadjust_tpu/ops/pallas_matvec.py:263",
        "launches": sum(main_path),
        "p_values": sorted({r["shape"]["P"] for r in rec["schur_wz"].values()}),
        "max_abs_err": max(r["max_abs_err"] for r in rec["schur_wz"].values()),
        "ms": b["device_ms"], "op_wall_ms": b["op_wall_ms"], "wall_ms": b["wall_ms"],
        "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": None,
        "at": "slice B shape (M=1000, K=800000, P=3), ms = device time, op_wall_ms through "
              "the bound operator; launches by slice A, B, C, D, E sequential, E global, "
              "F perspective, F affine, F CLI, G1, G2, H1a, H1b (both ranks), H2 reference, "
              "H2 (both ranks), J ba (its six solves; the parity gate's call not counted) "
              "{}; ".format(main_path) + other,
    }]
    replaces = {"nn2_batched_i8": "sat_bundleadjust_tpu/ops/pallas_match.py:240",
                "nn2_batched": "sat_bundleadjust_tpu/ops/pallas_match.py:294",
                "nn2_single": "sat_bundleadjust_tpu/ops/pallas_match.py:353"}
    for name, where in replaces.items():
        k = rec["nn2"][name]
        entries.append({
            "name": name, "route": "cuda", "source": "sat_bundleadjust_tpu_torch/csrc/nn2_match.cu",
            "replaces": where,
            "launches": (c["launches"][name] + rec["slice_i"]["launches"][name]
                         + rec["slice_d"]["launches"][name]
                         + sum(rec["slice_e"][m]["launches"][name] for m in rec["slice_e"])
                         + rec["slice_f"]["cli"]["launches"][name]
                         + sum(rec["slice_g"][g]["launches"][name] for g in rec["slice_g"])
                         + rec["slice_h"]["H2"]["reference"]["launches"][name]
                         + rec["slice_h"]["H2"]["launches"][name]
                         + rec["slice_j"]["tracks"]["launches"][name]),
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "at": "slice C's largest staged chunk, B={B} n1={n1} n2={n2}; launches by slices C, "
                  "I, D, E, F CLI, G, H2 reference, H2, J tracks".format(**k["shape"]),
        })
    def slice_launches(name):
        return (c["launches"][name] + rec["slice_i"]["launches"][name]
                + rec["slice_d"]["launches"][name]
                + sum(rec["slice_e"][m]["launches"][name] for m in rec["slice_e"])
                + rec["slice_f"]["cli"]["launches"][name]
                + sum(rec["slice_g"][g]["launches"][name] for g in rec["slice_g"])
                + rec["slice_h"]["H2"]["reference"]["launches"][name]
                + rec["slice_h"]["H2"]["launches"][name]
                + rec["slice_j"]["tracks"]["launches"][name])

    sift_launches = {name: slice_launches(name) for name in ("blur", "upsample2")}
    r = rec["rpc_triangulate"]
    entries.append({
        "name": "rpc_triangulate", "route": "cuda",
        "source": "sat_bundleadjust_tpu_torch/csrc/rpc_triangulate.cu", "replaces": None,
        "launches": slice_launches("rpc_triangulate"),
        "max_abs_err": r["max_point_gap_m"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "at": "rpc_ba1000_clean.robust's outlier pass, {duos} duos, {cameras} cameras (max_abs_err "
              "in m); launches by slices C, I, D, E, F CLI, G, H2 reference, H2, J "
              "tracks".format(**r["shape"]),
    })
    for name, r in ((n, rec["sift_blur"][n]) for n in ("blur", "upsample2")):
        entries.append({
            "name": "sift_" + name, "route": "cuda",
            "source": "sat_bundleadjust_tpu_torch/csrc/sift_blur.cu", "replaces": None,
            "launches": sift_launches[name],
            "max_abs_err": 0.0 if rec["sift_blur"]["bit_identical"][name] else None,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "at": "rpc_date10.cli's batch, {B} x {h}x{w} (blur: the first octave, r = {radius}); "
                  "launches by slices C, I, D, E, F CLI, G, H2 reference, H2, J "
                  "tracks".format(**rec["sift_blur"]["shape"]),
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
