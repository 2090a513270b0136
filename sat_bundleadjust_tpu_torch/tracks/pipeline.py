"""FeatureTracksPipeline: detection -> pair selection -> matching -> tracks.

Counterpart of `sat_bundleadjust_tpu/tracks/pipeline.py`, with the same
stages, the same npy cache layout (features/, features_utm/,
pairwise_matches/) and the same in-memory handoff when FT_save is False in
one process. Detection and the 2-NN matching run on `device` (default: the
card); the F init, RANSAC, UTM coordinates and track building are host
numpy, as there. With FT_kp_aoi and an AOI, each image's AOI mask is
written to <output_dir>/masks/<id>.npy (cropped to its offset) and
restricts its keypoints, whichever the detector.

Several processes (parallel/multihost.py): each detects its own images and
matches its own pairs (round-robin over the ranks) and the stages exchange
their results through the npy caches of the shared output directory,
behind barriers; rank 0 alone writes the portable artifacts.
"""

import os

import numpy as np

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.parallel import multihost
from sat_bundleadjust_tpu_torch.parallel.mesh import world_size
from sat_bundleadjust_tpu_torch.tracks import build as ft_build
from sat_bundleadjust_tpu_torch.tracks import detection as ft_detection
from sat_bundleadjust_tpu_torch.tracks import matching as ft_matching
from sat_bundleadjust_tpu_torch.tracks.pairs import compute_pairs_to_match
from sat_bundleadjust_tpu_torch.utils import geo as geo_utils
from sat_bundleadjust_tpu_torch.utils import io as loader
from sat_bundleadjust_tpu_torch.utils.config import init_feature_tracks_config
from sat_bundleadjust_tpu_torch.utils.io import flush_print
from sat_bundleadjust_tpu_torch.utils.profiling import span


class FeatureTracksPipeline:
    def __init__(self, input_dir, output_dir, local_data, tracks_config=None, device=None):
        """local_data holds "images" (SatelliteImage list, with footprints
        and camera centers set), "n_adj" and "aoi". `timing` collects the
        seconds of every stage of the last build_feature_tracks, `counts`
        its images and pairs read from the npy caches or computed
        (features_cached, features_detected, pairs_cached, pairs_matched)."""
        self.device = resolve_device(device)
        self.input_dir = input_dir
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.images = local_data["images"]
        self.n_adj = local_data["n_adj"]
        self.aoi = local_data.get("aoi")
        self.config = init_feature_tracks_config(tracks_config)
        self.config["in_dir"] = self.input_dir
        self.config["out_dir"] = self.output_dir
        # a backend the port does not run raises here, before any stage runs
        ft_detection.check_backend(self.config["FT_sift_detection"])
        ft_matching._check_method(self.config["FT_sift_matching"])
        self.mask_paths = None
        if self.config["FT_kp_aoi"] and self.aoi is not None:
            masks_dir = os.path.join(self.output_dir, "masks")
            os.makedirs(masks_dir, exist_ok=True)
            self.mask_paths = []
            # the masks serve detection only, whose images are dealt over
            # the processes by the same rule: each writes (and reads) its own
            owned = set(multihost.partition_by_process(len(self.images)))
            for k, im in enumerate(self.images):
                mask_path = os.path.join(masks_dir, loader.get_id(im.geotiff_path) + ".npy")
                if k in owned:
                    y0, x0 = int(im.offset["row0"]), int(im.offset["col0"])
                    h, w = int(im.offset["height"]), int(im.offset["width"])
                    mask = loader.get_binary_mask_from_aoi_lonlat_within_image(
                        h, w, im.rpc, self.aoi, alt=im.alt or 0.0)
                    np.save(mask_path, mask[y0:y0 + h, x0:x0 + w])
                self.mask_paths.append(mask_path)
        self.timing = {}
        self.counts = dict.fromkeys(
            ("features_cached", "features_detected", "pairs_cached", "pairs_matched"), 0)

    def run_feature_detection(self):
        """Detect keypoints in every image. In one process with FT_save
        False the features stay in memory and feed the matcher directly;
        else they go through the features/ and features_utm/ npy caches
        (several processes exchange them there)."""
        image_paths = [im.geotiff_path for im in self.images]
        offsets = [im.offset for im in self.images]
        handoff = world_size() == 1 and not self.config["FT_save"]
        cfg = dict(self.config, FT_save=not handoff)
        feats_mem = ft_detection.detect_features_image_sequence(
            image_paths, self.mask_paths, offsets, cfg, device=self.device,
            timing=self.timing, counts=self.counts)

        if handoff:
            self.features = list(feats_mem)
            with span("tracks.features_utm"):
                self.features_utm = [
                    ft_matching.keypoints_to_utm_coords(f, im.rpc, im.offset, im.alt or 0.0)
                    for f, im in zip(feats_mem, self.images)
                ]
            return

        self.features = ["{}/features/{}.npy".format(self.output_dir, loader.get_id(p))
                         for p in image_paths]
        self.features_utm = ["{}/features_utm/{}.npy".format(self.output_dir, loader.get_id(p))
                             for p in image_paths]
        # several processes: the UTM coordinates follow detection's images,
        # synced before any process reads another's
        owned = set(multihost.partition_by_process(len(self.images)))
        with span("tracks.features_utm"):
            for k, (npy, npy_utm, im) in enumerate(zip(self.features, self.features_utm,
                                                       self.images)):
                if k not in owned or (not self.config["FT_reset"] and os.path.exists(npy_utm)):
                    continue
                utm = ft_matching.keypoints_to_utm_coords(np.load(npy, mmap_mode="r"), im.rpc,
                                                          im.offset, im.alt or 0.0)
                os.makedirs(os.path.dirname(npy_utm), exist_ok=True)
                np.save(npy_utm, utm)
        multihost.barrier("features_utm")

    def get_stereo_pairs_to_match(self):
        """Pairs to match and pairs to triangulate, from footprint overlap
        and baseline."""
        self.n_new = len(self.images) - self.n_adj
        if len(self.config["FT_predefined_pairs"]) == 0:
            n = self.n_adj + self.n_new
            init_pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        else:
            init_pairs = self.config["FT_predefined_pairs"]
        self.footprints = [
            {"geojson": geo_utils.utm_geojson_from_lonlat_geojson(im.lonlat_geojson), "z": im.alt}
            for im in self.images
        ]
        self.optical_centers = [im.center for im in self.images]
        args = [init_pairs, self.footprints, self.optical_centers]
        if self.config["FT_filter_pairs"]:
            self.pairs_to_match, self.pairs_to_triangulate = compute_pairs_to_match(*args)
        else:
            self.pairs_to_match, self.pairs_to_triangulate = compute_pairs_to_match(
                *args, min_overlap=0, min_baseline=0)
        print("{} pairs to match".format(len(self.pairs_to_match)))

    def run_feature_matching(self):
        """Epipolar F init (epipolar_based), then the matching of all pairs."""
        F = None
        if self.config["FT_sift_matching"] == "epipolar_based":
            with span("tracks.F_init", self.timing, "F_init_s"):
                F = ft_matching.init_F_pairs_batched(self.pairs_to_match, self.images)
        self.pairwise_matches = ft_matching.match_stereo_pairs(
            self.pairs_to_match, self.features, self.footprints, self.features_utm,
            self.config, F, device=self.device, timing=self.timing, counts=self.counts)
        print("Found {} new pairwise matches".format(self.pairwise_matches.shape[0]))

    def get_feature_tracks(self):
        """The track bundle from the pairwise matches: C, C_v2 and the pair
        lists. Tracks seen by no camera under adjustment lead C."""
        C = C_v2 = None
        n_pts_fix = 0
        if len(self.pairwise_matches):
            C, C_v2 = ft_build.feature_tracks_from_pairwise_matches(
                self.features, self.pairwise_matches, self.pairs_to_triangulate)
            seen_by_new = np.isfinite(C[2 * self.n_adj::2]).any(axis=0)
            n_pts_fix = int(np.size(seen_by_new) - np.count_nonzero(seen_by_new))
            if n_pts_fix:
                perm = np.argsort(seen_by_new, kind="stable")
                C, C_v2 = C[:, perm], C_v2[:, perm]
        flush_print("Found {} tracks in total".format(0 if C is None else C.shape[1]))
        return {
            "C": C,
            "C_v2": C_v2,
            "features": self.features,
            "pairwise_matches": self.pairwise_matches,
            "pairs_to_triangulate": self.pairs_to_triangulate,
            "pairs_to_match": self.pairs_to_match,
            "n_pts_fix": n_pts_fix,
        }

    def _save_portable_artifacts(self):
        """Filenames manifest, flat matches table and pair lists."""
        out = self.output_dir
        loader.save_list_of_paths(os.path.join(out, "filenames.txt"),
                                  [im.geotiff_path for im in self.images])
        np.save(os.path.join(out, "matches.npy"), self.pairwise_matches)
        loader.save_list_of_pairs(os.path.join(out, "pairs_matching.npy"), self.pairs_to_match)
        loader.save_list_of_pairs(os.path.join(out, "pairs_triangulation.npy"),
                                  self.pairs_to_triangulate)

    def build_feature_tracks(self):
        """Run every stage; returns (feature_tracks dict, total seconds)."""
        print("Building feature tracks\n")
        print("Parameters:")
        loader.display_dict(self.config)
        self.timing = {}

        def timed(label, name, key, fn):
            flush_print("\n[tracks] {}...".format(label))
            with span(name, self.timing, key):
                out = fn()
            flush_print("[tracks] {}: {:.2f} s".format(label, self.timing[key]))
            return out

        with span("tracks.run") as wall:
            timed("feature detection", "tracks.detection", "detection_s",
                  self.run_feature_detection)
            timed("pair selection", "tracks.pairs", "pairs_s", self.get_stereo_pairs_to_match)
            if len(self.pairs_to_match) > 0:
                timed("matching", "tracks.matching", "matching_s", self.run_feature_matching)
            else:
                self.pairwise_matches = np.zeros((0, 4), dtype=np.int64)
                flush_print("\n[tracks] matching: nothing to do (no pairs)")
            feature_tracks = timed("track construction", "tracks.build", "tracks_s",
                                   self.get_feature_tracks)
            if self.config.get("FT_save") and multihost.is_main_process():
                timed("portable artifacts", "tracks.artifacts", "artifacts_s",
                      self._save_portable_artifacts)

        total = wall.seconds
        flush_print("\nFeature tracks computed in {}\n".format(
            loader.get_time_in_hours_mins_secs(total)))
        return feature_tracks, total
