"""Outlier observation rejection by reprojection error.

Counterpart of `sat_bundleadjust_tpu/ba/outliers.py`: per-camera elbow
thresholds on the sorted error curve, removal of the flagged observations,
track re-filtering (>= 2 observations and a triangulation pair),
re-triangulation and parameter rebuild. Host-side numpy between the two
solves, except the re-triangulation, which runs on `device`.
"""

import numpy as np

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.ba.params import BAParams


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


def filter_C_using_pairs_to_triangulate(C, pairs_to_triangulate):
    """Indices of tracks with at least one triangulation pair."""
    n_cam = C.shape[0] // 2
    mask = (~np.isnan(C[::2])).astype(np.float64)  # (M, N)
    P = np.zeros((n_cam, n_cam))
    for (i, j) in pairs_to_triangulate:
        if i < n_cam and j < n_cam:
            P[i, j] = P[j, i] = 1.0
    hits = np.einsum("mn,mk,kn->n", mask, P, mask)
    return np.where(hits > 0)[0]


def compute_obs_to_remove(err, p: BAParams, predef_thr=None, min_thr=1.0,
                          reference_rounding=False):
    """Per-camera thresholds and the C matrix without the flagged
    observations: (C_new, cam_thr, n_detected). reference_rounding compares
    against np.round(thr, 2), as the reference does."""
    err = np.asarray(err)
    cam_thr = []
    for cam_idx in range(p.n_cam):
        sel = p.cam_ind == cam_idx
        if predef_thr is None:
            if np.sum(sel) == 0:
                cam_thr.append(np.inf)
                continue
            elbow_value, success = get_elbow_value(err[sel])
            thr = max(elbow_value, min_thr) if success else float(np.max(err[sel]))
            cam_thr.append(thr)
        else:
            cam_thr.append(float(predef_thr))

    thr_arr = np.array(cam_thr)
    if reference_rounding:
        thr_arr = np.round(thr_arr, 2)
    to_rm = err > thr_arr[p.cam_ind]
    C_new = p.C.copy()
    rm_cam = p.cam_ind[to_rm]
    rm_pts = p.pts_ind[to_rm]
    C_new[rm_cam * 2, rm_pts] = np.nan
    C_new[rm_cam * 2 + 1, rm_pts] = np.nan
    return C_new, cam_thr, int(np.sum(to_rm))


def reset_ba_params_after_outlier_removal(C_new, p: BAParams, verbose=True, device=None):
    """Re-filter tracks, re-triangulate and rebuild the parameters."""
    from sat_bundleadjust_tpu_torch.ops.triangulate import init_pts3d

    obs_per_track = np.sum(~np.isnan(C_new), axis=0)
    keep1 = np.where(obs_per_track >= 4)[0]  # >= 2 (col, row) observations
    C_new = C_new[:, keep1]

    keep2 = filter_C_using_pairs_to_triangulate(C_new, p.pairs_to_triangulate)
    C_new = C_new[:, keep2]

    final_left = keep1[keep2]
    n_pts_fix_new = int(np.sum(final_left < p.n_pts_fix))

    pts3d_new = init_pts3d(C_new, p.cameras, p.cam_model, p.pairs_to_triangulate,
                           device=device)
    if n_pts_fix_new > 0:
        prev_fixed = final_left[final_left < p.n_pts_fix]
        pts3d_new[:n_pts_fix_new, :] = p.pts3d[prev_fixed, :]

    new_p = BAParams(
        C_new, pts3d_new, p.cameras, p.cam_model, p.pairs_to_triangulate, p.camera_centers,
        {
            "n_cam_fix": p.n_cam_fix,
            "n_pts_fix": n_pts_fix_new,
            "reduce": False,
            "verbose": verbose,
            "correction_params": p.cam_params_to_optimize,
            "ref_cam_weight": p.ref_cam_weight,
        },
    )
    new_p.pts_prev_indices = p.pts_prev_indices[final_left]
    return new_p


def rm_outliers(err, p: BAParams, predef_thr=None, min_thr=1.0, verbose=False,
                reference_rounding=False, device=None):
    """Remove outlier observations of p given per-observation errors err;
    returns the new BAParams (p itself when nothing is removed)."""
    device = resolve_device(device)
    C_new, cam_thr, n_detected = compute_obs_to_remove(
        err, p, predef_thr, min_thr, reference_rounding=reference_rounding
    )
    new_p = (reset_ba_params_after_outlier_removal(C_new, p, verbose=verbose, device=device)
             if n_detected > 0 else p)
    if verbose:
        n_obs_in = len(p.cam_ind)
        n_tracks_in = p.C.shape[1]
        n_tracks_rm = n_tracks_in - new_p.C.shape[1]
        print("Reprojection error threshold per camera: {} px".format(
            [round(t, 2) for t in cam_thr]))
        print("Deleted {} observations ({:.2f}%) and {} tracks ({:.2f}%)".format(
            n_detected, n_detected / max(n_obs_in, 1) * 100,
            n_tracks_rm, n_tracks_rm / max(n_tracks_in, 1) * 100))
    return new_p
