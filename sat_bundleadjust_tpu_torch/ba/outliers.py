"""Outlier observation rejection by reprojection error.

Counterpart of `sat_bundleadjust_tpu/ba/outliers.py`: per-camera elbow
thresholds on the sorted error curve, removal of the flagged observations,
track re-filtering (>= 2 observations and a triangulation pair),
re-triangulation and parameter rebuild. `rm_outliers` does all of it on
the observation table, on `device`, with no array of cameras x tracks: the
thresholds of every camera at once (`camera_thresholds`), the pair test and
the re-triangulation's duos by a key lookup of each track's camera pairs
(`ops/triangulate.py`), the rebuild through `BAParams.from_obs_table`.
`get_elbow_value` is the rule for one curve (the tracks layer's matching
takes it too).
"""

import numpy as np
import torch

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.ba.params import BAParams
from sat_bundleadjust_tpu_torch.utils.profiling import span


def get_elbow_value(err, max_outliers_percent=20, verbose=False):
    """Elbow of the sorted error curve = point furthest from the chord.
    Returns (elbow_value, success)."""
    values = np.sort(np.asarray(err))
    n_pts = len(values)
    if n_pts < 3:
        return float(values[-1]) if n_pts else 0.0, False
    coords = np.stack([np.arange(n_pts, dtype=np.float64), values], axis=1)
    line_vec = coords[-1] - coords[0]
    norm = np.linalg.norm(line_vec)
    if norm == 0:
        return float(values[-1]), False
    line_vec = line_vec / norm
    from_first = coords - coords[0]
    proj = from_first @ line_vec
    dist = np.linalg.norm(from_first - np.outer(proj, line_vec), axis=1)
    elbow_value = float(values[np.argmax(dist)])
    success = elbow_value >= np.percentile(err, 100 - max_outliers_percent)
    return elbow_value, bool(success)


def camera_thresholds(err, cam_ind, n_cam, min_thr=1.0, max_outliers_percent=20):
    """Each camera's threshold (get_elbow_value's elbow where it succeeds,
    at least min_thr, else the camera's largest error), for all cameras at
    once on err's device: (n_cam,) float64, inf for a camera without
    observations. err (K,) float32 or float64, cam_ind (K,) int64. The
    elbow is get_elbow_value's point furthest from the chord (the first of
    equals), the percentile numpy's linear one, in err's dtype as numpy
    computes it."""
    dev, dt, f64 = err.device, err.dtype, torch.float64
    K = err.numel()
    if K == 0:
        return torch.full((n_cam,), float("inf"), dtype=f64, device=dev)
    order = torch.sort(err, stable=True).indices
    order = order[torch.sort(cam_ind[order], stable=True).indices]
    vals, cam = err[order], cam_ind[order]  # each camera's errors, sorted
    n = torch.bincount(cam_ind, minlength=n_cam)
    start = torch.cumsum(n, 0) - n
    rank = torch.arange(K, device=dev) - start[cam]
    first = torch.clamp(start, max=K - 1)
    last = torch.clamp(start + n - 1, 0, K - 1)

    # the elbow: distance of (rank, value) from the chord, in float64
    v = vals.to(f64)
    lx, ly = (n - 1).to(f64), v[last] - v[first]
    norm = torch.sqrt(lx * lx + ly * ly)
    ux, uy = (lx / norm)[cam], (ly / norm)[cam]
    fx, fy = rank.to(f64), v - v[first][cam]
    proj = fx * ux + fy * uy
    dx, dy = fx - proj * ux, fy - proj * uy
    dist = torch.sqrt(dx * dx + dy * dy)
    far = torch.full((n_cam,), -float("inf"), dtype=f64, device=dev).scatter_reduce(
        0, cam, dist, "amax")
    at = torch.full((n_cam,), K, dtype=torch.int64, device=dev).scatter_reduce(
        0, cam, torch.where(dist == far[cam], rank, K), "amin")
    elbow = v[torch.clamp(start + at, max=K - 1)]

    # np.percentile(err, 100 - max_outliers_percent), method "linear"
    q = torch.tensor(100 - max_outliers_percent, dtype=dt) / torch.tensor(100, dtype=dt)
    vi = (n - 1).to(dt) * q.to(dev)
    lo = torch.floor(vi)
    gamma = vi - lo
    hi_ = torch.clamp(start + lo.long() + 1, max=K - 1)
    a, b = vals[torch.clamp(start + lo.long(), 0, K - 1)], vals[hi_]
    diff = b - a
    pct = torch.where(gamma >= 0.5, b - diff * (1 - gamma), a + diff * gamma)

    success = (n >= 3) & (elbow >= pct.to(f64))
    thr = torch.where(success, torch.clamp(elbow, min=float(min_thr)), v[last])
    return torch.where(n > 0, thr, float("inf"))


def rm_outliers(err, p: BAParams, predef_thr=None, min_thr=1.0, verbose=False,
                reference_rounding=False, device=None):
    """Remove outlier observations of p given per-observation errors err;
    returns the new BAParams (p itself when nothing is removed).

    On the observation table: the per-camera thresholds
    (camera_thresholds, or predef_thr; with reference_rounding compared as
    np.round(thr, 2)); the observations above them removed; the tracks kept
    that have >= 2 observations left and a listed pair of their cameras;
    those re-triangulated (ops/triangulate.triangulate_table, on `device`;
    the first n_pts_fix keep their points); the rebuild by
    BAParams.from_obs_table, with n_pts_fix and pts_prev_indices carried
    over. The `ba.outliers` span holds the counts and the host's reads of
    the device (host_reads)."""
    from sat_bundleadjust_tpu_torch.ops.triangulate import (host_read, pair_lookup,
                                                            tracks_with_a_pair,
                                                            triangulate_table, true_rows)

    device = resolve_device(device)
    with span("ba.outliers", observations=p.n_obs, cameras=p.n_cam, tracks_in=p.n_pts,
              host_reads=0) as outer:
        reads = outer.attrs
        pts_all = torch.as_tensor(np.asarray(p.pts_ind)).to(device).long()
        cam_all = torch.as_tensor(np.asarray(p.cam_ind)).to(device).long()
        err = torch.as_tensor(err).to(device)
        with span("ba.outliers.thresholds"):
            if predef_thr is None:
                thr = camera_thresholds(err, cam_all, p.n_cam, min_thr)
            else:
                thr = torch.full((p.n_cam,), float(predef_thr), dtype=torch.float64,
                                 device=device)
            cut = torch.round(thr, decimals=2) if reference_rounding else thr
        with span("ba.outliers.remove"):
            rows = true_rows(err.to(torch.float64) <= cut[cam_all], reads)
            n_detected = p.n_obs - rows.numel()
        if n_detected == 0:
            new_p = p
        else:
            with span("ba.outliers.filter"):
                pts, cam = pts_all[rows], cam_all[rows]
                lookup = pair_lookup(p.pairs_to_triangulate, p.n_cam, device)
                keep = (torch.bincount(pts, minlength=p.n_pts) >= 2) & tracks_with_a_pair(
                    pts, cam, p.n_pts, p.n_cam, lookup, reads)
                rows = rows[true_rows(keep[pts], reads)]
                final_left = true_rows(keep, reads)
                pts, cam = (torch.cumsum(keep, 0) - 1)[pts_all[rows]], cam_all[rows]
            n_kept = final_left.numel()
            with span("ba.outliers.triangulate", tracks=n_kept) as tri:
                pts2d = torch.as_tensor(np.asarray(p.pts2d, np.float64)).to(device)[rows]
                pts3d, tri.attrs["duos"] = triangulate_table(
                    pts, cam, pts2d, n_kept, p.n_cam, p.cameras, p.cam_model,
                    p.pairs_to_triangulate, rpcs=p.rpcs, lookup=lookup, reads=reads)
                rows, final_left, pts, pts3d = (host_read(x, reads)
                                                for x in (rows, final_left, pts, pts3d))
            with span("ba.outliers.rebuild"):
                fixed = final_left[final_left < p.n_pts_fix]
                pts3d[: len(fixed)] = p.pts3d[fixed]
                new_p = BAParams.from_obs_table(
                    pts.astype(np.int32), p.cam_ind[rows], p.pts2d[rows], pts3d, p.cameras,
                    p.cam_model, p.camera_centers, p.pairs_to_triangulate,
                    {
                        "n_cam_fix": p.n_cam_fix,
                        "n_pts_fix": len(fixed),
                        "verbose": verbose,
                        "correction_params": p.cam_params_to_optimize,
                        "ref_cam_weight": p.ref_cam_weight,
                    },
                )
                new_p.pts_prev_indices = p.pts_prev_indices[final_left]
        cam_thr = host_read(thr, reads).tolist() if verbose else None
        outer.attrs.update(removed=n_detected, tracks_out=new_p.n_pts)
    if verbose:
        if new_p is not p:
            new_p.print_definition()
        n_tracks_rm = p.n_pts - new_p.n_pts
        print("Reprojection error threshold per camera: {} px".format(
            [round(t, 2) for t in cam_thr]))
        print("Deleted {} observations ({:.2f}%) and {} tracks ({:.2f}%)".format(
            n_detected, n_detected / max(p.n_obs, 1) * 100,
            n_tracks_rm, n_tracks_rm / max(p.n_pts, 1) * 100))
    return new_p
