"""Feature tracks from a portable predefined-matches bundle.

Counterpart of `sat_bundleadjust_tpu/tracks/predefined.py`. A bundle
(written by utils/io.save_predefined_matches from an FT_save matches
directory) carries what the tracks front end would otherwise compute: a
filenames manifest, each image's keypoint (col, row, scale) array and one
flat (kp_i, kp_j, im_i, im_j) match table. Reading it skips detection and
matching. The bundle format and the returned feature_tracks dict are the
JAX package's, so a bundle written by either package is read by both.
Host numpy throughout, as there.
"""

import os
import timeit

import numpy as np

from sat_bundleadjust_tpu_torch.tracks import build as ft_build
from sat_bundleadjust_tpu_torch.tracks.pairs import compute_pairs_to_match
from sat_bundleadjust_tpu_torch.utils import geo as geo_utils
from sat_bundleadjust_tpu_torch.utils import io as loader


def resolve_bundle_indices(src_im_paths, target_fnames):
    """Index of each target image inside the bundle manifest, matched by
    basename. Returns (indices ndarray, missing basenames list)."""
    src_index = {os.path.basename(p): k for k, p in enumerate(src_im_paths)}
    indices, missing = [], []
    for fname in target_fnames:
        bn = os.path.basename(fname)
        if bn in src_index:
            indices.append(src_index[bn])
        else:
            missing.append(bn)
    return np.asarray(indices, dtype=np.int64), missing


def stage_bundle_features(input_dir, output_dir, src_im_paths, bundle_indices):
    """Materialize the bundle's (col, row, scale) keypoint arrays as
    standard Nx132 feature files under output_dir/features (descriptor
    slots filled with ones — predefined matches never re-match, so only
    the geometry columns are consumed downstream)."""
    features_dir = os.path.join(output_dir, "features")
    os.makedirs(features_dir, exist_ok=True)
    staged = []
    for idx in bundle_indices:
        file_id = loader.get_id(src_im_paths[idx])
        kp = np.load(os.path.join(input_dir, "keypoints", file_id + ".npy"))
        feats = np.ones((kp.shape[0], 132))
        feats[:, :3] = kp[:, :3]
        out_npy = os.path.join(features_dir, file_id + ".npy")
        np.save(out_npy, feats)
        staged.append(out_npy)
    return staged


def default_pair_grid(n_adj, n_new):
    """Candidate pairs when none are predefined: every (adjusted, new)
    combination plus all new-new combinations — i.e. every pair touching
    at least one new image, as (i, j) with i < j."""
    total = n_adj + n_new
    ii, jj = np.triu_indices(total, k=1)
    touches_new = jj >= n_adj  # j > i, so j >= n_adj covers both cases
    return list(zip(ii[touches_new].tolist(), jj[touches_new].tolist()))


def remap_bundle_matches(matches, bundle_indices, n_bundle_images):
    """Restrict the bundle's flat match table to the images in use and
    renumber its image columns to target indices, canonicalizing each row
    to im_i < im_j (keypoint columns swap along). Fully vectorized."""
    lut = np.full(n_bundle_images, -1, dtype=np.int64)
    lut[bundle_indices] = np.arange(len(bundle_indices))
    im_i = lut[matches[:, 2].astype(np.int64)]
    im_j = lut[matches[:, 3].astype(np.int64)]
    usable = (im_i >= 0) & (im_j >= 0)
    kp_i = matches[usable, 0].astype(np.int64)
    kp_j = matches[usable, 1].astype(np.int64)
    im_i, im_j = im_i[usable], im_j[usable]
    flip = im_i > im_j
    out = np.empty((usable.sum(), 4), dtype=np.int64)
    out[:, 0] = np.where(flip, kp_j, kp_i)
    out[:, 1] = np.where(flip, kp_i, kp_j)
    out[:, 2] = np.minimum(im_i, im_j)
    out[:, 3] = np.maximum(im_i, im_j)
    return out


def load_tracks_from_predefined_matches(input_dir, output_dir, local_data, tracks_config):
    """Same contract as FeatureTracksPipeline.build_feature_tracks."""
    start = timeit.default_timer()

    images = local_data["images"]
    local_data["fnames"] = [im.geotiff_path for im in images]
    local_data["footprints"] = [
        {"geojson": geo_utils.utm_geojson_from_lonlat_geojson(im.lonlat_geojson),
         "z": im.alt}
        for im in images
    ]
    local_data["optical_centers"] = [im.center for im in images]

    print("Consuming predefined-matches bundle: {}".format(input_dir))
    src_im_paths = loader.load_list_of_paths(os.path.join(input_dir, "filenames.txt"))
    bundle_indices, missing = resolve_bundle_indices(src_im_paths, local_data["fnames"])
    for bn in missing:
        print("ERROR: {} has no entry in the bundle manifest "
              "(filenames.txt) — its observations will be absent".format(bn))

    feature_paths = stage_bundle_features(
        input_dir, output_dir, src_im_paths, bundle_indices)

    n_adj = local_data["n_adj"]
    init_pairs = tracks_config["FT_predefined_pairs"] or default_pair_grid(
        n_adj, len(local_data["fnames"]) - n_adj)
    pairs_to_match, pairs_to_triangulate = compute_pairs_to_match(
        init_pairs, local_data["footprints"], local_data["optical_centers"]
    )

    matches = remap_bundle_matches(
        np.load(os.path.join(input_dir, "matches.npy")),
        bundle_indices, len(src_im_paths))
    print("{} predefined stereo matches cover the target images".format(len(matches)))

    C, C_v2 = ft_build.feature_tracks_from_pairwise_matches(
        feature_paths, matches, pairs_to_triangulate
    )
    # fixed tracks (never observed by a camera under adjustment) lead the
    # C columns — the stable permutation shared with
    # tracks.pipeline.get_feature_tracks
    seen_by_new = np.isfinite(C[2 * n_adj :: 2]).any(axis=0)
    n_pts_fix = int(np.size(seen_by_new) - np.count_nonzero(seen_by_new))
    if n_pts_fix:
        perm = np.argsort(seen_by_new, kind="stable")
        C, C_v2 = C[:, perm], C_v2[:, perm]
    print("Found {} tracks in total".format(C.shape[1]))

    feature_tracks = {
        "C": C,
        "C_v2": C_v2,
        "features": feature_paths,
        "pairwise_matches": matches,
        "pairs_to_triangulate": pairs_to_triangulate,
        "pairs_to_match": pairs_to_match,
        "n_pts_fix": n_pts_fix,
    }
    if tracks_config["FT_save"]:
        loader.save_list_of_paths(
            os.path.join(output_dir, "filenames.txt"), local_data["fnames"])
        np.save(os.path.join(output_dir, "matches.npy"), matches)
        loader.save_list_of_pairs(
            os.path.join(output_dir, "pairs_matching.npy"), pairs_to_match)
        loader.save_list_of_pairs(
            os.path.join(output_dir, "pairs_triangulation.npy"), pairs_to_triangulate)

    elapsed = timeit.default_timer() - start
    print("\nFeature tracks computed in {}\n".format(
        loader.get_time_in_hours_mins_secs(elapsed)))
    return feature_tracks, elapsed
