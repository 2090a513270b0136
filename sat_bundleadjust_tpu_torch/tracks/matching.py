"""Pairwise matching orchestration over stereo pairs.

Counterpart of `sat_bundleadjust_tpu/tracks/matching.py`: the
restriction of each pair's keypoints to the bounding box of the UTM
intersection of the two footprints, the epipolar F init, the 2-NN stage for
all pairs at once, RANSAC and the UTM geo-consistency elbow filter, and the
npy match caching protocol. With several processes (parallel/multihost.py)
each matches only its own pairs, on its own device, and the processes
exchange their results through the pairwise_matches/ cache of the shared
output directory.

The 2-NN stage follows the JAX package's dispatch (`ops/match.py`):
* on the card (`cuda`) the frames are staged once as int8 and every pair's
  operands are gathered on the device for the int8 kernel
  (`match_pairs_2nn_staged`); where staging declines (descriptors that are
  not integers in 0..255) the host-packed f32 kernel runs instead, as the
  JAX package does on a TPU;
* on the CPU each pair goes through `match_descriptors_2nn`, the JAX
  package's CPU matcher (symmetric epipolar gate);
* FT_sift_matching "lightglue" (the optional LightGlue package,
  `tracks/lightglue.py`) matches one pair at a time on `device`, as there.
F init, RANSAC and the UTM filter are host numpy on both.
"""

import os
import uuid
from collections import OrderedDict

import numpy as np

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.ba.outliers import get_elbow_value
from sat_bundleadjust_tpu_torch.models.cameras import generate_point_mesh
from sat_bundleadjust_tpu_torch.models.rpc import rpc_localization_np, rpc_projection_np
from sat_bundleadjust_tpu_torch.ops import match as match_ops
from sat_bundleadjust_tpu_torch.ops.ransac import MIN_SAMPLES, ransac_fundamental_many
from sat_bundleadjust_tpu_torch.parallel import multihost
from sat_bundleadjust_tpu_torch.parallel.mesh import world_size
from sat_bundleadjust_tpu_torch.tracks import lightglue
from sat_bundleadjust_tpu_torch.utils import geo as geo_utils
from sat_bundleadjust_tpu_torch.utils.io import get_id
from sat_bundleadjust_tpu_torch.utils.profiling import span

# process-unique prefix of the tokens that name in-memory features
_MEM_TOKEN_SESSION = uuid.uuid4().hex[:8]
_DEVICE_METHODS = ("epipolar_based", "bruteforce", "flann", "absolute")


class _FrameCache:
    """Budget-bounded LRU of decoded per-frame arrays (features, UTM
    coordinates), so that a frame's npy is read once and not once per pair.
    Budget in MB via SATBA_FEATURE_CACHE_MB (default 4096)."""

    def __init__(self, budget_mb=None):
        if budget_mb is None:
            budget_mb = int(os.environ.get("SATBA_FEATURE_CACHE_MB", 4096))
        self.budget = budget_mb * (1 << 20)
        self.entries = OrderedDict()
        self.bytes = 0

    def get(self, key, source):
        if key in self.entries:
            self.entries.move_to_end(key)
            return self.entries[key]
        arr = np.load(source) if isinstance(source, str) else np.asarray(source)
        self.entries[key] = arr
        self.bytes += arr.nbytes
        while self.bytes > self.budget and len(self.entries) > 1:
            _, old = self.entries.popitem(last=False)
            self.bytes -= old.nbytes
        return arr


def _guard_mem_token(npy_name):
    """In-memory feature tokens are session-local: a cache file named after
    one would give stale hits in a later session, so it is never written."""
    if npy_name.startswith("mem-"):
        raise RuntimeError(
            "refusing to persist a session-local in-memory match id "
            "({}); pass FT_save=True only with on-disk features".format(npy_name))
    return npy_name


def keypoints_to_utm_coords(im_features, im_rpc, im_offset, alt):
    """Approximate (east, north) of each keypoint, localized at the footprint
    altitude (host numpy Newton localization)."""
    im_features = np.asarray(im_features)
    n_kp = int(np.sum(~np.isnan(im_features[:, 0])))
    cols = im_features[:n_kp, 0] + im_offset["col0"]
    rows = im_features[:n_kp, 1] + im_offset["row0"]
    lon, lat = rpc_localization_np(im_rpc, cols, rows, np.full(n_kp, float(alt)))
    east, north = geo_utils.utm_from_lonlat(np.asarray(lon), np.asarray(lat))
    utm = np.stack((east, north), axis=1)
    rest = im_features[n_kp:, :2].copy()
    return np.vstack((utm, rest))


def get_pt_indices_inside_utm_bbx(easts, norths, min_east, max_east, min_north, max_north):
    east_ok = (easts > min_east) & (easts < max_east)
    north_ok = (norths > min_north) & (norths < max_north)
    return np.where(east_ok & north_ok)[0]


def filter_matches_inconsistent_utm_coords(matches_ij, utm_i, utm_j):
    """Elbow filter on the distances between matched UTM coordinates."""
    pt_i = utm_i[matches_ij[:, 0]]
    pt_j = utm_j[matches_ij[:, 1]]
    d = np.linalg.norm(pt_i - pt_j, axis=1)
    utm_thr, success = get_elbow_value(d, max_outliers_percent=20)
    utm_thr = utm_thr + 5 if success else np.max(d)
    return matches_ij[d <= utm_thr]


def utm_bbox_indices(utm_i, utm_j, utm_polygon):
    east_poly = utm_polygon.coords[:, 0]
    north_poly = utm_polygon.coords[:, 1]
    box = (east_poly.min(), east_poly.max(), north_poly.min(), north_poly.max())
    return (get_pt_indices_inside_utm_bbx(utm_i[:, 0], utm_i[:, 1], *box),
            get_pt_indices_inside_utm_bbx(utm_j[:, 0], utm_j[:, 1], *box))


def _check_method(method_cfg):
    """Raise for a FT_sift_matching that cannot run: local_window (as in
    the JAX package), lightglue without its package, an unknown name."""
    if method_cfg == "local_window":
        # the reference's local-window matcher depends on an imscript
        # binary (siftu.so) that it does not ship either
        raise NotImplementedError(
            "FT_sift_matching='local_window' requires the imscript siftu "
            "binary, which the reference does not ship; use "
            "'epipolar_based' or 'bruteforce'")
    if method_cfg == "lightglue":
        if not lightglue.lightglue_available():
            raise ImportError(lightglue.MISSING_PACKAGE)
    elif method_cfg not in _DEVICE_METHODS:
        raise ValueError("unknown FT_sift_matching: {}".format(method_cfg))


def match_kp_within_utm_polygon(features_i, features_j, utm_i, utm_j, utm_polygon,
                                tracks_config, F=None, device=None):
    """Match one pair's keypoints inside the bounding box of the UTM
    intersection polygon (ops/match.match_pair), then the UTM filter.
    features_* and utm_* may be arrays or .npy paths. Returns (matches_ij
    or None, counts)."""
    load = lambda x: np.load(x, mmap_mode="r") if isinstance(x, str) else np.asarray(x)  # noqa: E731
    features_i, features_j = load(features_i), load(features_j)
    utm_i, utm_j = load(utm_i), load(utm_j)
    idx_i, idx_j = utm_bbox_indices(utm_i, utm_j, utm_polygon)
    if len(idx_i) == 0 or len(idx_j) == 0:
        return None, [0, 0, 0]

    fi, fj = np.asarray(features_i[idx_i]), np.asarray(features_j[idx_j])
    method_cfg = tracks_config["FT_sift_matching"]
    common = {"ransac_thr": tracks_config["FT_ransac"], "device": device}
    if method_cfg == "epipolar_based":
        matches_poly, n_ratio, n_ransac = match_ops.match_pair(
            fi, fj, F=F, rel_thr=tracks_config["FT_rel_thr"], method="relative", **common)
        n = [n_ransac]
    elif method_cfg in ("bruteforce", "flann"):
        matches_poly, n_ratio, n_ransac = match_ops.match_pair(
            fi, fj, F=None, rel_thr=tracks_config["FT_rel_thr"], method="relative", **common)
        n = [n_ratio, n_ransac]
    elif method_cfg == "absolute":
        matches_poly, n_ratio, n_ransac = match_ops.match_pair(
            fi, fj, F=F, abs_thr=tracks_config["FT_abs_thr"], method="absolute", **common)
        n = [n_ratio, n_ransac]
    elif method_cfg == "lightglue":
        matches_poly, n_matches, n_final = lightglue.lightglue_matching(fi, fj, **common)
        n = [n_matches, n_final]
    else:
        _check_method(method_cfg)

    matches_ij = _remap_and_filter(matches_poly, idx_i, idx_j, utm_i, utm_j)
    n.append(0 if matches_ij is None else matches_ij.shape[0])
    return matches_ij, n


def _remap_and_filter(matches_poly, idx_i, idx_j, utm_i, utm_j):
    """Matches between the keypoints of two UTM boxes -> matches between
    the full keypoint arrays, through the UTM filter (None stays None)."""
    if matches_poly is None:
        return None
    matches_ij = np.stack([idx_i[matches_poly[:, 0]], idx_j[matches_poly[:, 1]]], axis=1)
    if matches_ij.shape[0] == 0:
        return matches_ij
    return filter_matches_inconsistent_utm_coords(matches_ij, utm_i, utm_j)


def _virtual_mesh(h, w, rpc, n=5):
    """The 5^3 grid of virtual matches over the image and the altitude
    validity range of rpc."""
    alt_off = float(np.asarray(rpc.alt_offset))
    alt_sc = float(np.asarray(rpc.alt_scale))
    return generate_point_mesh(
        [(1.0 / (2 * n)) * w, ((2 * n - 1.0) / (2 * n)) * w, n],
        [(1.0 / (2 * n)) * h, ((2 * n - 1.0) / (2 * n)) * h, n],
        [alt_off - alt_sc, alt_off + alt_sc, n],
    )


def init_F_pair_to_match(h, w, rpc_i, rpc_j):
    """Affine fundamental matrix of one pair from the 5^3 grid of RPC virtual
    matches of an h x w image (host numpy; init_F_pairs_batched does every
    pair at once)."""
    cols, rows, alts = _virtual_mesh(h, w, rpc_i)
    lons, lats = rpc_i.localization(cols, rows, alts)
    x1, y1 = rpc_i.projection(lons, lats, alts)
    x2, y2 = rpc_j.projection(lons, lats, alts)
    return affine_fundamental_matrix(np.vstack([x1, y1, x2, y2]).T)


def affine_fundamental_matrix(matches):
    """Gold Standard affine F of (N, 4) matches (x1, y1, x2, y2)."""
    X = matches[:, [2, 3, 0, 1]]
    N = len(X)
    XX = np.sum(X, axis=0) / N
    A = X - np.tile(XX, (N, 1))
    _, _, V = np.linalg.svd(A)
    Nv = V[-1, :]
    F = np.zeros((3, 3))
    F[0, 2] = Nv[0]
    F[1, 2] = Nv[1]
    F[2, 0] = Nv[2]
    F[2, 1] = Nv[3]
    F[2, 2] = -np.dot(Nv, XX)
    return F


def init_F_pairs_batched(pairs_to_match, images):
    """Affine fundamental matrices of every pair, host numpy: localization
    once per unique first image, one projection per pair, one batched SVD."""
    P = len(pairs_to_match)
    if P == 0:
        return []
    geom_of = {}
    for i in {i for (i, _) in pairs_to_match}:
        c, r, a = _virtual_mesh(images[i].offset["height"], images[i].offset["width"],
                                images[i].rpc)
        lon, lat = rpc_localization_np(images[i].rpc, c, r, a)
        px, py = rpc_projection_np(images[i].rpc, lon, lat, a)
        geom_of[i] = (lon, lat, a, px, py)
    x1 = np.stack([geom_of[i][3] for (i, _) in pairs_to_match])
    y1 = np.stack([geom_of[i][4] for (i, _) in pairs_to_match])
    x2 = np.empty_like(x1)
    y2 = np.empty_like(y1)
    for k, (i, j) in enumerate(pairs_to_match):
        lon, lat, a, _, _ = geom_of[i]
        x2[k], y2[k] = rpc_projection_np(images[j].rpc, lon, lat, a)
    # Gold Standard affine F per pair, one (P, 125, 4) SVD call
    X = np.stack([x2, y2, x1, y1], axis=2)
    XX = X.mean(axis=1)
    _, _, V = np.linalg.svd(X - XX[:, None, :])
    Nv = V[:, -1, :]
    Fs = np.zeros((P, 3, 3))
    Fs[:, 0, 2] = Nv[:, 0]
    Fs[:, 1, 2] = Nv[:, 1]
    Fs[:, 2, 0] = Nv[:, 2]
    Fs[:, 2, 1] = Nv[:, 3]
    Fs[:, 2, 2] = -np.einsum("pk,pk->p", Nv, XX)
    return list(Fs)


def _finalize_pairs_from_nn_batched(items, nn_results, tracks_config, timing=None):
    """RANSAC across all pairs at once (ransac_fundamental_many), the remap
    to the full keypoint arrays, then the UTM filter.

    items: (idx, fi, fj, idx_i, idx_j, utm_i, utm_j) per pair; nn_results:
    (nn_idx, accepted) per pair. Returns matches_ij (or None) per pair."""
    thr = tracks_config["FT_ransac"]
    prelim = []
    pts1_list, pts2_list, ransac_pos = [], [], []
    with span("matching.collect", timing, "collect_s"):
        for pos, ((_idx, fi, fj, *_rest), (nn, acc)) in enumerate(zip(items, nn_results)):
            ii = np.where(np.asarray(acc))[0]
            m = np.stack([ii, np.asarray(nn)[ii]], axis=1).astype(np.int64)
            prelim.append(m if m.shape[0] > 0 else None)
            if thr is not None and m.shape[0] >= MIN_SAMPLES:
                pts1_list.append(fi[m[:, 0], :2])
                pts2_list.append(fj[m[:, 1], :2])
                ransac_pos.append(pos)
    with span("matching.ransac", timing, "ransac_s", pairs=len(pts1_list)):
        if pts1_list:
            for pos, (_F, inl) in zip(ransac_pos, ransac_fundamental_many(pts1_list, pts2_list,
                                                                          thr=thr)):
                prelim[pos] = None if inl is None or inl.sum() == 0 else prelim[pos][inl]
    results = []
    with span("matching.utm", timing, "utm_s"):
        for pos, (_idx, _fi, _fj, idx_i, idx_j, utm_i, utm_j) in enumerate(items):
            m = prelim[pos]
            if m is None or m.shape[0] == 0:
                results.append(None)
                continue
            matches_ij = np.stack([idx_i[m[:, 0]], idx_j[m[:, 1]]], axis=1)
            results.append(filter_matches_inconsistent_utm_coords(matches_ij, utm_i, utm_j))
    return results


def match_stereo_pairs(pairs_to_match, features, footprints, utm_coords, tracks_config,
                       F=None, device=None, timing=None, counts=None):
    """Match all pairs; returns (K, 4) int64 rows (kp_i, kp_j, im_i, im_j).

    Matches are cached per pair id in <in_dir>/pairwise_matches/<idA>_<idB>.npy
    and reused in either order unless FT_reset. `timing` (a dict), if given,
    receives the seconds of each stage: prep_s (caches, UTM boxes), stage_s
    (frames to the device), nn_s (the 2-NN of all pairs, operand assembly
    and drain included; on the staged path split into nn_enqueue_s and
    nn_drain_s), finalize_s (RANSAC and UTM, split into collect_s, ransac_s
    and utm_s) and assemble_s. `counts` (a dict), if given, adds the pairs
    read from the cache (pairs_cached) and the others (pairs_matched)."""
    dev = resolve_device(device)
    timing = {} if timing is None else timing
    F = [None] * len(pairs_to_match) if F is None else F
    in_dir = tracks_config.get("in_dir", "")
    out_dir = tracks_config.get("out_dir", "")
    fid = lambda x: get_id(x) if isinstance(x, str) else "mem-{}-{}".format(  # noqa: E731
        _MEM_TOKEN_SESSION, id(x))
    method_cfg = tracks_config["FT_sift_matching"]
    _check_method(method_cfg)
    staged_intent = dev.type == "cuda" and method_cfg in _DEVICE_METHODS
    # several processes: each matches its own pairs, on its own device
    multiproc = world_size() > 1
    if multiproc and not out_dir:
        raise ValueError("multi-process matching needs out_dir (the npy exchange through a "
                         "shared directory)")
    owned = set(multihost.partition_by_process(len(pairs_to_match))) if multiproc else None

    frame_cache = _FrameCache()
    utm_cache = _FrameCache()

    # pass 1: caches, and each uncached pair's keypoints inside its UTM box
    with span("matching.prep", timing, "prep_s"):
        resolved = [None] * len(pairs_to_match)
        npy_ids = [None] * len(pairs_to_match)
        from_cache = [False] * len(pairs_to_match)
        to_match = []  # (idx, fi, fj, idx_i, idx_j, utm_i, utm_j)
        to_match_frames = []
        remote = []  # uncached pairs another process matches
        with span("matching.cache_read"):
            for idx, (i, j) in enumerate(pairs_to_match):
                npy_id1 = "{}_{}.npy".format(fid(features[i]), fid(features[j]))
                npy_id2 = "{}_{}.npy".format(fid(features[j]), fid(features[i]))
                npy_path1 = os.path.join(in_dir, "pairwise_matches", npy_id1)
                npy_path2 = os.path.join(in_dir, "pairwise_matches", npy_id2)
                npy_ids[idx] = npy_id1
                if in_dir and os.path.exists(npy_path1) and not tracks_config["FT_reset"]:
                    resolved[idx] = np.load(npy_path1)
                    from_cache[idx] = npy_path1
                elif in_dir and os.path.exists(npy_path2) and not tracks_config["FT_reset"]:
                    resolved[idx] = np.load(npy_path2)[:, ::-1]
                    npy_ids[idx] = npy_id2
                    from_cache[idx] = npy_path2
        n_cached = sum(bool(c) for c in from_cache)
        if counts is not None:
            counts["pairs_cached"] = counts.get("pairs_cached", 0) + n_cached
            counts["pairs_matched"] = (counts.get("pairs_matched", 0) + len(pairs_to_match)
                                       - n_cached)
        for idx, (i, j) in enumerate(pairs_to_match):
            if from_cache[idx]:
                continue
            if owned is not None and idx not in owned:
                remote.append(idx)
                continue

            poly_i = geo_utils.geojson_to_polygon(footprints[i]["geojson"])
            poly_j = geo_utils.geojson_to_polygon(footprints[j]["geojson"])
            utm_polygon = poly_i.intersection(poly_j)
            if utm_polygon.coords.shape[0] < 3:
                continue
            utm_i = utm_cache.get(i, utm_coords[i])
            utm_j = utm_cache.get(j, utm_coords[j])
            idx_i, idx_j = utm_bbox_indices(utm_i, utm_j, utm_polygon)
            if len(idx_i) == 0 or len(idx_j) == 0:
                continue
            frame_i = frame_cache.get(i, features[i])
            frame_j = frame_cache.get(j, features[j])
            if staged_intent:
                # the staged matcher gathers descriptors on the device; the
                # host keeps the coordinates (RANSAC, UTM filter)
                fi, fj = frame_i[idx_i, :2], frame_j[idx_j, :2]
            else:
                fi, fj = np.asarray(frame_i[idx_i]), np.asarray(frame_j[idx_j])
            to_match.append((idx, fi, fj, idx_i, idx_j, utm_i, utm_j))
            to_match_frames.append((i, j))

    # pass 2: the 2-NN stage of every pair at once, then RANSAC and UTM;
    # LightGlue matches one pair at a time, as in the JAX package
    if to_match and method_cfg == "lightglue":
        with span("matching.lightglue", timing, "finalize_s"):
            for (idx, fi, fj, idx_i, idx_j, utm_i, utm_j) in to_match:
                m, _, _ = lightglue.lightglue_matching(
                    fi, fj, ransac_thr=tracks_config["FT_ransac"], device=dev)
                resolved[idx] = _remap_and_filter(m, idx_i, idx_j, utm_i, utm_j)
    elif to_match:
        pair_F = [None if method_cfg in ("bruteforce", "flann") else F[idx]
                  for (idx, *_rest) in to_match]
        kw = {"rel_thr": float(tracks_config["FT_rel_thr"]),
              "abs_thr": float(tracks_config["FT_abs_thr"]),
              "method": "absolute" if method_cfg == "absolute" else "relative"}
        nn_results = None
        if staged_intent:
            frames_used = sorted({f for ij in to_match_frames for f in ij})
            fmap = {f: k for k, f in enumerate(frames_used)}
            with span("matching.stage", timing, "stage_s", frames=len(frames_used)) as stage:
                staged = match_ops.stage_frames_for_matching(
                    [frame_cache.get(f, features[f]) for f in frames_used], device=dev,
                    counts=stage.attrs)
            if staged is not None:
                with span("matching.nn", timing, "nn_s", pairs=len(to_match)):
                    nn_results = match_ops.match_pairs_2nn_staged(
                        staged, [(fmap[i], fmap[j]) for (i, j) in to_match_frames],
                        [(idx_i, idx_j) for (_, _, _, idx_i, idx_j, *_r) in to_match],
                        pair_F, timing=timing, **kw)
        if nn_results is None:
            with span("matching.nn", timing, "nn_s", pairs=len(to_match)):
                if staged_intent:
                    # staging declined (non-integer descriptors): the host
                    # packer needs the full 132-column rows
                    pair_feats = [(np.asarray(frame_cache.get(i, features[i])[idx_i]),
                                   np.asarray(frame_cache.get(j, features[j])[idx_j]))
                                  for ((i, j), (_, _, _, idx_i, idx_j, *_r))
                                  in zip(to_match_frames, to_match)]
                else:
                    pair_feats = [(fi, fj) for (_, fi, fj, *_r) in to_match]
                nn_results = match_ops.match_pairs_2nn_batched(pair_feats, pair_F, device=dev,
                                                               **kw)
        with span("matching.finalize", timing, "finalize_s"):
            for (idx, *_rest), matches_ij in zip(
                    to_match, _finalize_pairs_from_nn_batched(to_match, nn_results,
                                                              tracks_config, timing)):
                resolved[idx] = matches_ij

    if multiproc:
        # publish this process's pairs (empty results too: "matched, none
        # found" differs from "not matched"), sync, read the others'
        for (idx, *_rest) in to_match:
            out_path = os.path.join(out_dir, "pairwise_matches", _guard_mem_token(npy_ids[idx]))
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            m = resolved[idx]
            np.save(out_path, np.zeros((0, 2), np.int64) if m is None else np.asarray(m))
        multihost.barrier("pairwise_matching")
        for idx in remote:
            out_path = os.path.join(out_dir, "pairwise_matches", npy_ids[idx])
            if os.path.exists(out_path):  # the owner may have skipped the pair
                m = np.load(out_path)
                resolved[idx] = m if m.shape[0] > 0 else None

    # pass 3: assemble, print, write caches (a cached result is written again
    # when the output cache is elsewhere than where it was read; with several
    # processes the own pairs were published above and rank 0 alone
    # relocates cache hits)
    with span("matching.assemble", timing, "assemble_s"):
        kp_rows, im_rows = [], []
        for idx, (i, j) in enumerate(pairs_to_match):
            matches_ij = resolved[idx]
            n_matches = 0 if matches_ij is None else matches_ij.shape[0]
            if from_cache[idx]:
                print("{:4} matches (from pre-existing file) in pair {}".format(n_matches, (i, j)),
                      flush=True)
            else:
                print("{:4} matches in pair {}".format(n_matches, (i, j)), flush=True)
            if n_matches > 0:
                kp_rows.append(np.asarray(matches_ij, dtype=np.int64))
                im_rows.append(np.broadcast_to(np.array([i, j], dtype=np.int64), (n_matches, 2)))
                if tracks_config.get("FT_save") and out_dir:
                    out_path = os.path.join(out_dir, "pairwise_matches",
                                            _guard_mem_token(npy_ids[idx]))
                    if multiproc:
                        write = (from_cache[idx] and out_path != from_cache[idx]
                                 and multihost.is_main_process() and not os.path.exists(out_path))
                    else:
                        write = out_path != from_cache[idx]
                    if write:
                        os.makedirs(os.path.dirname(out_path), exist_ok=True)
                        np.save(out_path, np.asarray(matches_ij))
    if not kp_rows:
        return np.zeros((0, 4), dtype=np.int64)
    return np.hstack((np.concatenate(kp_rows), np.concatenate(im_rows)))
