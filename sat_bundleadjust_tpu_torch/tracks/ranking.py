"""Feature track selection: K spanning trees over the camera connectivity
graph, tracks ranked by (length, scale, cost).

Counterpart of `sat_bundleadjust_tpu/tracks/ranking.py` (host numpy, as
there; the algorithm of "Tracks selection for robust, efficient and
scalable large-scale structure from motion", Pattern Recognition 2017).
Only the reprojection errors of `compute_C_reproj` run on `device`.
"""

import os

import numpy as np

from sat_bundleadjust_tpu_torch.tracks.build import build_connectivity_matrix


def compute_C_scale(C_v2, features):
    """(M, N) keypoint scale per observation."""
    C_scale = np.array(C_v2, dtype=np.float64, copy=True)
    for cam_idx in range(C_v2.shape[0]):
        kp = np.load(features[cam_idx], mmap_mode="r") if isinstance(features[cam_idx], str) else np.asarray(features[cam_idx])
        where_obs = ~np.isnan(C_v2[cam_idx, :])
        kp_indices = C_v2[cam_idx, where_obs].astype(np.int64)
        C_scale[cam_idx, where_obs] = np.asarray(kp[:, 2])[kp_indices]
    return C_scale


def compute_C_reproj(C, pts3d, cameras, cam_model, pairs_to_triangulate, camera_centers,
                     device=None):
    """(M, N) reprojection error per observation at the initial
    parameters; the residuals are computed on `device`."""
    import torch

    from sat_bundleadjust_tpu_torch import resolve_device
    from sat_bundleadjust_tpu_torch.ba.params import BAParams
    from sat_bundleadjust_tpu_torch.ba.solver import _reproj_err, make_fns

    dev = resolve_device(device)
    p = BAParams(C, pts3d, cameras, cam_model, pairs_to_triangulate, camera_centers,
                 {"reduce": False, "verbose": False})
    residual_fn, _ = make_fns(p, dev)
    r = residual_fn(torch.as_tensor(p.opt_block(), dtype=torch.float64, device=dev),
                    torch.as_tensor(p.pts3d, dtype=torch.float64, device=dev))
    err = _reproj_err(r.cpu().numpy(), p.pts2d_w)
    n_cam, n_pts = C.shape[0] // 2, C.shape[1]
    C_reproj = np.full((n_cam, n_pts), np.nan)
    C_reproj[p.cam_ind, p.pts_ind] = err
    return C_reproj


def compute_camera_weights(C, C_reproj, connectivity_matrix=None):
    """W(cam) = neighbors(cam) + e^(-cost(cam))."""
    n_cam, n_tracks = C.shape[0] // 2, C.shape[1]
    A = build_connectivity_matrix(C, min_matches=0) if connectivity_matrix is None else connectivity_matrix
    mask = ~np.isnan(C[::2])
    w_cam = []
    for i in range(n_cam):
        nC_i = int(np.sum(A[i, :] > 0))
        if nC_i > 0:
            seen = np.arange(n_tracks)[mask[i]]
            with np.errstate(invalid="ignore"):
                avg = np.nanmean(C_reproj[:, seen], axis=0)
            cost = float(np.mean(avg) + 3.0 * np.std(avg))
        else:
            cost = 0.0
        w_cam.append(float(nC_i) + np.exp(-cost))
    return w_cam


def print_quick_camera_weights(geotiff_paths, C):
    """Print the cameras by neighbours and median observations per
    neighbour."""
    n_cam, n_pts = C.shape[0] // 2, C.shape[1]
    A = build_connectivity_matrix(C, min_matches=0)
    w_cam = np.array(compute_camera_weights(C, np.zeros((n_cam, n_pts)))).astype(int)
    obs_cam = np.floor(np.median(A, axis=1)).astype(int)
    print("Cameras sorted by neighboring cameras and feature track observations:")
    dtype = [("neighbors", int), ("obs", int)]
    vals = np.array(list(zip(w_cam, obs_cam)), dtype=dtype)
    for i in np.argsort(vals, order=["neighbors", "obs"])[::-1]:
        print(
            "    - cam {:3} - {} - neighbors {} - median obs per neighbor {}".format(
                i, os.path.basename(geotiff_paths[i]), w_cam[i], obs_cam[i]
            )
        )


def order_tracks(C, C_scale, C_reproj, priority=("length", "scale", "cost")):
    """Rank tracks by priority: {track index: rank}."""
    n_tracks = C.shape[1]
    with np.errstate(invalid="ignore"):
        tracks_length = (np.sum(~np.isnan(C), axis=0) / 2).astype(np.int32)
        tracks_scale = np.round(np.nanmean(C_scale, axis=0), 2)
        tracks_cost = np.nanmean(C_reproj, axis=0)
    tracks_scale = np.nan_to_num(tracks_scale)
    tracks_cost = np.nan_to_num(tracks_cost)
    dtype = [("length", int), ("scale", float), ("cost", float)]
    vals = np.array(list(zip(tracks_length, -tracks_scale, -tracks_cost)), dtype=dtype)
    return dict(zip(np.argsort(vals, order=list(priority))[::-1], np.arange(n_tracks)))


def get_inverted_track_list(C, ranked_track_indices):
    """Per camera, the tracks it sees, best ranked first."""
    inverted = []
    mask = ~np.isnan(C[::2])
    for i in range(C.shape[0] // 2):
        seen = np.where(mask[i])[0]
        inverted.append(sorted(seen, key=lambda idx: ranked_track_indices[idx]))
    return inverted


def _get_tracks_current_tree(A, V, cam_weights, cam_indices_per_track, inverted_track_list):
    """One BFS spanning tree of tracks from the heaviest camera."""
    cam_indices_per_cam = [set(np.nonzero(A[i])[0]) for i in range(A.shape[1])]
    Croot = int(np.argmax(cam_weights))
    last_layer = [Croot]
    Sk, Ik = set(), {Croot}
    while True:
        next_layer = []
        for cam_idx in last_layer:
            for track_idx in inverted_track_list[cam_idx]:
                if track_idx in Sk:
                    continue
                not_done = (cam_indices_per_track[track_idx] & cam_indices_per_cam[cam_idx]) - Ik
                if not_done:
                    next_layer.extend(not_done)
                    Sk.add(track_idx)
                    Ik |= not_done
        if len(V - Ik) == 0 or not next_layer:
            break
        last_layer = sorted(next_layer, key=lambda a: -cam_weights[a])
    return Sk


def get_tracks(C, C_reproj, K, ranked_track_indices):
    """K spanning trees of track selection."""
    n_cam = C.shape[0] // 2
    T = set(range(C.shape[1]))
    V = set(range(n_cam))
    k, S = 0, []
    mask = ~np.isnan(C[::2])
    cam_indices_per_track = [set(np.where(mask[:, t])[0]) for t in range(C.shape[1])]
    updated_C = C.copy()
    while k < K and len(S) < len(T):
        A = build_connectivity_matrix(updated_C, min_matches=0)
        inverted = get_inverted_track_list(updated_C, ranked_track_indices)
        weights = np.array(compute_camera_weights(updated_C, C_reproj, connectivity_matrix=A))
        Sk = _get_tracks_current_tree(A, V, weights, cam_indices_per_track, inverted)
        k += 1
        S.extend(Sk)
        updated_C[:, list(Sk)] = np.nan
    return S


def select_best_tracks(C, C_scale, C_reproj, K=30, priority=("length", "scale", "cost"), verbose=False):
    """Indices of the tracks kept by K spanning trees over the ranking."""
    ranked = order_tracks(C, C_scale, C_reproj, priority=priority)
    S = get_tracks(C, C_reproj, K, ranked)
    if verbose:
        n_out, n_in = len(S), C.shape[1]
        print("Selected {} tracks out of {} ({:.2f}%)".format(n_out, n_in, n_out / max(n_in, 1) * 100.0))
    return np.array(S, dtype=np.int64)


def select_best_tracks_sensor_aware(images, C, C_scale, C_reproj, K=30,
                                    priority=("length", "scale", "cost"), verbose=False):
    """SkySat d1/d2/d3 sensor-split selection, then over all cameras."""
    n_input_tracks = C.shape[1]
    S = np.array([], dtype=np.int64)
    for d in ("d1_", "d2_", "d3_"):
        cams = np.array([i for i, x in enumerate(images) if d in x.geotiff_path])
        if len(cams) < 2:
            continue
        tracks = np.arange(n_input_tracks)[np.sum(~np.isnan(C[2 * cams]), axis=0) >= 2]
        rows = np.vstack((2 * cams, 2 * cams + 1)).T.ravel()
        C_ = C[:, tracks][rows].copy()
        C_scale_ = C_scale[:, tracks][cams].copy()
        C_reproj_ = C_reproj[:, tracks][cams].copy()
        S_d = select_best_tracks(C_, C_scale_, C_reproj_, K=K, priority=priority, verbose=verbose)
        S = np.hstack((S, tracks[S_d])).astype(np.int64)
    S_all = select_best_tracks(C, C_scale, C_reproj, K=K, priority=priority, verbose=verbose)
    return np.unique(np.hstack((S, S_all)).astype(np.int64))
