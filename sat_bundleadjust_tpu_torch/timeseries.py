"""Scene / time-series driver: loads geotiffs and RPCs, groups the images
into acquisition dates and runs the bundle adjustment.

Counterpart of `sat_bundleadjust_tpu/timeseries.py`, with the same config
keys, the three `rpc_src` values (txt, json, geotiff) and
the three BA modes: `ba_bruteforce` (every image at once), `ba_sequential`
(date by date, each against its n_dates previously adjusted dates, which
stay frozen) and `ba_global` (every image at once, pairs restricted to a
date and its next n_dates dates). With several processes
(parallel/multihost.py, the `distributed` key) every process runs the same
scene and rank 0 alone writes the shared files, behind barriers.
"""

import glob
import os
import shutil
import sys

import numpy as np
import torch

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.models.cameras import SatelliteImage
from sat_bundleadjust_tpu_torch.models.rpc import rpc_from_json_file, rpc_from_rpc_file
from sat_bundleadjust_tpu_torch.parallel import multihost
from sat_bundleadjust_tpu_torch.pipeline import BundleAdjustmentPipeline
from sat_bundleadjust_tpu_torch.utils import io as loader
from sat_bundleadjust_tpu_torch.utils.config import init_feature_tracks_config
from sat_bundleadjust_tpu_torch.utils.io import flush_print
from sat_bundleadjust_tpu_torch.utils.profiling import span

class Error(Exception):
    pass


def get_acquisition_date(geotiff_path):
    """TIFFTAG_DATETIME, else a YYYYMMDD_HHMMSS filename prefix."""
    import datetime

    from sat_bundleadjust_tpu_torch.utils import tiffmeta

    if os.path.exists(geotiff_path):
        dt = tiffmeta.datetime_from_tiff(geotiff_path)
        if dt is not None:
            return dt
    date_string = os.path.basename(geotiff_path)[:15]
    return datetime.datetime.strptime(date_string, "%Y%m%d_%H%M%S")


def group_files_by_date(datetimes, image_fnames, margin_mins=30.0):
    """Cluster images into acquisition groups: scanning in time order, an
    image joins the open group while it lies strictly within margin_mins of
    the group's first image."""
    order = np.argsort(datetimes, kind="stable")
    if len(order) == 0:
        return []
    t0 = datetimes[order[0]]
    offsets = np.array([(datetimes[i] - t0).total_seconds() for i in order])

    timeline = []
    start, n = 0, len(order)
    while start < n:
        end = int(np.searchsorted(offsets, offsets[start] + margin_mins * 60.0, side="left"))
        members = order[start:end]
        anchor = datetimes[members[0]]
        timeline.append({
            "datetime": anchor,
            "id": anchor.strftime("%Y%m%d_%H%M%S"),
            "fnames": [image_fnames[i] for i in members],
            "n_images": len(members),
            "adjusted": False,
            "image_weights": [],
        })
        start = end
    return timeline


class Scene:
    def __init__(self, scene_config, device=None):
        """scene_config: a json path or a dict with the keys of the JAX
        package's Scene (geotiff_dir, rpc_dir, rpc_src, output_dir,
        ba_method, ... and the FT_* keys). The run goes on `device`
        (default: the card). `timing` holds the scene load's seconds."""
        self.timing = {}
        with span("scene.load", self.timing, "scene_load_s"):
            self._load(scene_config, device)
        print("Scene loaded in {:.2f} seconds".format(self.timing["scene_load_s"]))

    def _load(self, scene_config, device):
        self.device = resolve_device(device)
        args = loader.load_dict_from_json(scene_config) if isinstance(scene_config, str) else dict(scene_config)

        self.geotiff_dir = args["geotiff_dir"]
        self.rpc_dir = args["rpc_dir"]
        self.rpc_src = args["rpc_src"]
        self.dst_dir = args["output_dir"]

        self.ba_method = args.get("ba_method", "ba_bruteforce")
        self.selected_timeline_indices = args.get("timeline_indices", None)
        self.geotiff_label = args.get("geotiff_label", None)
        self.n_dates = int(args.get("n_dates", 1))

        self.cam_model = args.get("cam_model", "rpc")
        self.correction_params = args.get("correction_params", ["R"])
        self.predefined_matches = args.get("predefined_matches", False)
        self.fix_ref_cam = args.get("fix_ref_cam", False)
        self.ref_cam_weight = float(args.get("ref_cam_weight", 1))
        self.clean_outliers = args.get("clean_outliers", True)
        self.reset = args.get("reset", True)
        self.remove_FT_files = args.get("remove_FT_files", False)
        self.save_figures = args.get("save_figures", True)
        self.extra_ba_config = {
            k: args[k]
            for k in ("max_init_reproj_error", "outlier_thr_rounding", "dem_path", "distributed")
            if k in args
        }

        if not os.path.isdir(self.geotiff_dir):
            raise Error('geotiff_dir "{}" does not exist'.format(self.geotiff_dir))
        if not os.path.isdir(self.rpc_dir):
            raise Error('rpc_dir "{}" does not exist'.format(self.rpc_dir))
        for v in self.correction_params:
            if v not in ["R", "T", "K", "COMMON_K"]:
                raise Error("{} is not a valid camera parameter to optimize".format(v))

        os.makedirs(self.dst_dir, exist_ok=True)
        self.init_ba_input_data()

        self.tracks_config = init_feature_tracks_config()
        for k in list(self.tracks_config.keys()):
            if k in args:
                self.tracks_config[k] = args[k]
        if "FT_max_kp" in args and "FT_kp_max" not in args:
            self.tracks_config["FT_kp_max"] = args["FT_max_kp"]

        self.aoi_lonlat = None
        self.timeline = self.load_scene()
        if "aoi_geojson" in args:
            self.aoi_lonlat = loader.load_geojson(args["aoi_geojson"])
            print("AOI geojson loaded from {}".format(args["aoi_geojson"]))
            loader.save_geojson("{}/AOI_init.json".format(self.dst_dir), self.aoi_lonlat)

        start_date = self.timeline[0]["datetime"].date()
        end_date = self.timeline[-1]["datetime"].date()
        print("Number of acquisition dates: {} (from {} to {})".format(len(self.timeline), start_date, end_date))
        print("Number of images: {}".format(int(np.sum([d["n_images"] for d in self.timeline]))))

    # ------------------------------------------------------------------

    def load_scene(self):
        """Every image's RPC (from rpc_src), its acquisition date, and the
        initial RPCs written to output_dir/rpcs_init. Scenes with .rpc files
        and no rasters are accepted (rpc_src txt)."""
        all_fnames, all_rpcs, all_datetimes = [], [], []

        geotiff_paths = sorted(glob.glob(os.path.join(self.geotiff_dir, "**/*.tif"), recursive=True))
        if not geotiff_paths and self.rpc_src == "txt":
            geotiff_paths = [p[: -len(".rpc")] + ".tif"
                             for p in sorted(glob.glob(os.path.join(self.rpc_dir, "*.rpc")))]
        if self.geotiff_label is not None:
            geotiff_paths = [fn for fn in geotiff_paths if self.geotiff_label in fn]

        for tif_fname in geotiff_paths:
            f_id = loader.get_id(tif_fname)
            if self.rpc_src == "geotiff":
                rpc = loader.rpc_from_geotiff(tif_fname)
            elif self.rpc_src == "json":
                rpc = rpc_from_json_file(os.path.join(self.rpc_dir, f_id + ".json"))
            elif self.rpc_src == "txt":
                rpc = rpc_from_rpc_file(os.path.join(self.rpc_dir, f_id + ".rpc"))
            else:
                raise ValueError("Unknown rpc_src value: {}".format(self.rpc_src))
            all_fnames.append(tif_fname)
            all_rpcs.append(rpc)
            all_datetimes.append(get_acquisition_date(tif_fname))

        init_rpcs_dir = os.path.join(self.dst_dir, "rpcs_init")
        if multihost.is_main_process():
            loader.save_rpcs(["{}/{}.rpc".format(init_rpcs_dir, loader.get_id(fn))
                              for fn in all_fnames], all_rpcs)
        multihost.barrier("rpcs_init")
        return group_files_by_date(all_datetimes, all_fnames)

    def get_timeline_attributes(self, timeline_indices, attributes):
        for idx in timeline_indices:
            row = ["{}".format(self.timeline[idx][a]) for a in attributes]
            print("  {} | {}".format(idx, " | ".join(row)))

    # ------------------------------------------------------------------

    def init_ba_input_data(self):
        self.n_adj = 0
        self.images_adj = []
        self.images_new = []

    def check_adjusted_dates(self, input_dir, t_idx):
        """Mark the dates before t_idx whose images have an .rpc_adj in
        input_dir/rpcs_adj as adjusted; True if there is one."""
        found = False
        dir_adj = os.path.join(input_dir, "rpcs_adj")
        if os.path.isdir(dir_adj):
            adj_fnames = []
            for adj_id in [loader.get_id(p) for p in glob.glob(dir_adj + "/*.rpc_adj")]:
                hits = glob.glob(os.path.join(self.geotiff_dir, "**/" + adj_id + ".tif"),
                                 recursive=True)
                # raster-less scenes: the virtual path
                adj_fnames.extend(hits or [os.path.join(self.geotiff_dir, adj_id + ".tif")])
            print("Found {} previously adjusted images in {}\n".format(len(adj_fnames), self.dst_dir))
            datetimes_adj = [get_acquisition_date(p) for p in adj_fnames]
            for d in group_files_by_date(datetimes_adj, adj_fnames):
                for idx in range(len(self.timeline)):
                    if self.timeline[idx]["id"] == d["id"] and idx < t_idx:
                        self.timeline[idx]["adjusted"] = True
                        found = True
        if not found:
            print("No previously adjusted data was found in {}\n".format(self.dst_dir))
        return found

    def load_data_from_dates(self, timeline_indices, input_dir, adjusted=False):
        """The images of the given dates: new ones with their initial RPCs,
        adjusted ones with their .rpc_adj from input_dir/rpcs_adj (counted
        in n_adj)."""
        im_fnames = []
        for t_idx in timeline_indices:
            im_fnames.extend(self.timeline[t_idx]["fnames"])
        flush_print("{} {} images for bundle adjustment !".format(
            len(im_fnames), "adjusted" if adjusted else "new"))
        images = []
        if im_fnames:
            if adjusted:
                rpc_dir, extension = os.path.join(input_dir, "rpcs_adj"), "rpc_adj"
            else:
                rpc_dir, extension = os.path.join(self.dst_dir, "rpcs_init"), "rpc"
            rpcs = loader.load_rpcs_from_dir(im_fnames, rpc_dir, extension=extension, verbose=True)
            images = [SatelliteImage(fn, rpc) for fn, rpc in zip(im_fnames, rpcs)]
        if adjusted:
            self.n_adj += len(im_fnames)
            self.images_adj.extend(images)
        else:
            self.images_new.extend(images)

    def load_prev_adjusted_dates(self, t_idx, input_dir, previous_dates=1):
        """The `previous_dates` adjusted dates closest to t_idx."""
        if self.check_adjusted_dates(input_dir, t_idx):
            prev = [i for i, d in enumerate(self.timeline) if d["adjusted"]]
            closest = sorted(prev, key=lambda x: abs(x - t_idx))[:previous_dates]
            self.load_data_from_dates(closest, input_dir, adjusted=True)

    def set_ba_input_data(self, t_indices, input_dir, output_dir, previous_dates):
        """The pipeline's input: the previously adjusted images (first),
        then the new ones of t_indices."""
        print("\nSetting bundle adjustment input data...\n")
        self.init_ba_input_data()
        if previous_dates > 0:
            self.load_prev_adjusted_dates(min(t_indices), input_dir, previous_dates=previous_dates)
        self.load_data_from_dates(t_indices, input_dir)
        self.ba_data = {"in_dir": input_dir, "out_dir": output_dir,
                        "images": self.images_adj + self.images_new}

    # ------------------------------------------------------------------

    def bundle_adjust(self):
        with span("scene.bundle_adjust") as wall:
            self._bundle_adjust()
        n_tracks = self.ba_pipeline.ba_params.pts3d_ba.shape[0]
        ba_e = float(np.mean(self.ba_pipeline.ba_e))
        init_e = float(np.mean(self.ba_pipeline.init_e))
        return (wall.seconds, self.ba_pipeline.feature_tracks_running_time, n_tracks, ba_e,
                init_e)

    def _bundle_adjust(self):
        extra = {
            "cam_model": self.cam_model,
            "n_adj": self.n_adj,
            "correction_params": self.correction_params,
            "predefined_matches": self.predefined_matches,
            "fix_ref_cam": self.fix_ref_cam,
            "ref_cam_weight": self.ref_cam_weight,
            "clean_outliers": self.clean_outliers,
            "save_figures": self.save_figures,
        }
        extra.update(self.extra_ba_config)
        if self.aoi_lonlat is not None:
            extra["aoi"] = self.aoi_lonlat
        self.ba_pipeline = BundleAdjustmentPipeline(self.ba_data, self.tracks_config, extra,
                                                    device=self.device)
        self.ba_pipeline.run()

    def rm_tmp_files_after_ba(self):
        if multihost.is_main_process():
            shutil.rmtree("{}/{}/matches".format(self.dst_dir, self.ba_method), ignore_errors=True)
        multihost.barrier("rm_tmp_files")

    def reset_ba_params(self):
        ba_dir = "{}/{}".format(self.dst_dir, self.ba_method)
        if multihost.is_main_process() and os.path.exists(ba_dir):
            shutil.rmtree(ba_dir)
        multihost.barrier("reset_ba_params")
        for t in self.timeline:
            t["adjusted"] = False

    def run_sequential_bundle_adjustment(self):
        """Date by date, each against its n_dates previously adjusted dates
        (frozen); pts3d_adj/<date id>_pts3d_adj.ply for each date. fix_ref_cam
        holds for the first date only (or every date with n_dates 0).
        `date_stats` keeps each date's wall, tracks, iterations, n_adj, the
        reprojection errors through the initial and the written RPCs, its
        pipeline's stage walls, LM counters and cache counts (`ft_counts`),
        and the date's whole wall (`date_s`, its `ts.date` span: the input
        data, the pipeline, the .ply copy and the reprojection errors)."""
        ba_dir = os.path.join(self.dst_dir, self.ba_method)
        os.makedirs(ba_dir, exist_ok=True)
        self.tracks_config["FT_predefined_pairs"] = []

        stats = {"time": [], "time_FT": [], "tracks": [], "init_e": [], "ba_e": [], "iters": [],
                 "n_adj": [], "reproj_after": [], "timing": [], "ft_timing": [], "ba_rounds": [],
                 "ft_counts": [], "date_s": []}
        fix_ref_cam_initial = self.fix_ref_cam
        for idx, t_idx in enumerate(self.selected_timeline_indices):
            with span("ts.date", date=idx, date_id=self.timeline[t_idx]["id"]) as date:
                self.set_ba_input_data([t_idx], ba_dir, ba_dir, self.n_dates)
                self.fix_ref_cam = fix_ref_cam_initial and (idx == 0 or self.n_dates == 0)
                n_adj = self.n_adj
                running_time, time_FT, n_tracks, ba_e, _ = self.bundle_adjust()
                if multihost.is_main_process():
                    pts_out = "{}/pts3d_adj/{}_pts3d_adj.ply".format(ba_dir,
                                                                     self.timeline[t_idx]["id"])
                    os.makedirs(os.path.dirname(pts_out), exist_ok=True)
                    shutil.copyfile(ba_dir + "/pts3d_adj.ply", pts_out)

                init_e, after_e = self.compute_reprojection_error_before_and_after_bundle_adjust()
                pipe = self.ba_pipeline
                date.attrs.update(n_adj=n_adj, n_new=len(self.images_new),
                                  cams_fixed=pipe.ba_params.n_cam_fix, pts_fixed=pipe.n_pts_fix,
                                  **pipe.ft_counts)
            for k, v in zip(["time", "time_FT", "tracks", "init_e", "ba_e", "iters", "n_adj",
                             "reproj_after", "timing", "ft_timing", "ba_rounds", "ft_counts",
                             "date_s"],
                            [running_time, time_FT, n_tracks, init_e, ba_e, pipe.ba_iters, n_adj,
                             after_e, dict(pipe.timing), dict(pipe.ft_timing), pipe.ba_rounds,
                             dict(pipe.ft_counts), date.seconds]):
                stats[k].append(v)
            flush_print("({}/{}) {} adjusted in {:.2f} seconds, {} ({:.3f}, {:.3f})".format(
                idx + 1, len(self.selected_timeline_indices), self.timeline[t_idx]["datetime"],
                running_time, n_tracks, init_e, ba_e))
        self.date_stats = stats
        self.fix_ref_cam = fix_ref_cam_initial
        if self.remove_FT_files:
            self.rm_tmp_files_after_ba()
        flush_print("All dates adjusted in {:.2f} seconds, mean reproj: ({:.3f}, {:.3f})".format(
            sum(stats["time"]), float(np.mean(stats["init_e"])), float(np.mean(stats["ba_e"]))))
        flush_print("Average BA iterations per date: {}".format(int(np.ceil(np.mean(stats["iters"])))))

    def run_global_bundle_adjustment(self):
        """Every selected date at once, pairs restricted to a date and its
        next n_dates dates."""
        ba_dir = os.path.join(self.dst_dir, self.ba_method)
        os.makedirs(ba_dir, exist_ok=True)
        self.tracks_config["FT_predefined_pairs"] = load_pairs_from_same_date_and_next_dates(
            self.timeline, self.selected_timeline_indices, self.n_dates)
        self._run_all_dates_at_once(ba_dir)

    def run_bruteforce_bundle_adjustment(self):
        ba_dir = os.path.join(self.dst_dir, self.ba_method)
        os.makedirs(ba_dir, exist_ok=True)
        self.tracks_config["FT_predefined_pairs"] = []
        self._run_all_dates_at_once(ba_dir)

    def _run_all_dates_at_once(self, ba_dir):
        self.set_ba_input_data(self.selected_timeline_indices, ba_dir, ba_dir, 0)
        running_time, time_FT, n_tracks, ba_e, init_e = self.bundle_adjust()
        if self.remove_FT_files:
            self.rm_tmp_files_after_ba()
        flush_print("All dates adjusted in {:.2f} seconds, {} ({:.3f}, {:.3f})".format(
            running_time, n_tracks, init_e, ba_e))
        flush_print("Total BA iterations: {}".format(int(self.ba_pipeline.ba_iters)))

    def is_ba_method_valid(self, ba_method):
        return ba_method in ["ba_global", "ba_sequential", "ba_bruteforce"]

    def compute_reprojection_error_before_and_after_bundle_adjust(self):
        """Mean reprojection error of the tracks of the last BA problem's
        observation table, triangulated and reprojected with the initial
        RPCs and with the written .rpc_adj files (re-read from disk)."""
        from sat_bundleadjust_tpu_torch.models.cameras import apply_rpc_projection_np
        from sat_bundleadjust_tpu_torch.ops.triangulate import triangulate_table

        im_fnames = [im.geotiff_path for im in self.ba_pipeline.images]
        p = self.ba_pipeline.ba_params
        table = [torch.as_tensor(x, device=self.device)
                 for x in (p.pts_ind.astype(np.int64), p.cam_ind.astype(np.int64), p.pts2d)]

        def triangulate(rpcs):
            pts3d, _ = triangulate_table(*table, p.n_pts, p.n_cam, rpcs, "rpc",
                                         p.pairs_to_triangulate)
            return pts3d.cpu().numpy()

        rpcs_init = loader.load_rpcs_from_dir(
            im_fnames, os.path.join(self.dst_dir, "rpcs_init"), extension="rpc", verbose=False)
        rpcs_ba = loader.load_rpcs_from_dir(
            im_fnames, os.path.join(self.dst_dir, self.ba_method, "rpcs_adj"),
            extension="rpc_adj", verbose=False)
        pts3d_before = triangulate(rpcs_init)
        pts3d_after = triangulate(rpcs_ba)

        err_before, err_after = [], []
        for cam_idx in range(p.n_cam):
            sel = p.cam_ind == cam_idx  # the camera's tracks, in ascending order
            obs2d, pts = p.pts2d[sel], p.pts_ind[sel]
            proj_b = apply_rpc_projection_np(rpcs_init[cam_idx], pts3d_before[pts])
            proj_a = apply_rpc_projection_np(rpcs_ba[cam_idx], pts3d_after[pts])
            err_before.extend(np.linalg.norm(proj_b - obs2d, axis=1).tolist())
            err_after.extend(np.linalg.norm(proj_a - obs2d, axis=1).tolist())
        return float(np.mean(err_before)), float(np.mean(err_after))

    def run_bundle_adjustment_for_RPC_refinement(self):
        if self.selected_timeline_indices is None:
            self.selected_timeline_indices = list(range(len(self.timeline)))
            flush_print("All dates selected to bundle adjust!\n")
        else:
            flush_print("Found {} selected dates to bundle adjust! timeline_indices: {}\n".format(
                len(self.selected_timeline_indices), self.selected_timeline_indices))
        for idx, t_idx in enumerate(self.selected_timeline_indices):
            flush_print("({}) {} --> {} views".format(
                idx + 1, self.timeline[t_idx]["datetime"], self.timeline[t_idx]["n_images"]))
        if self.reset:
            self.reset_ba_params()

        if self.ba_method == "ba_sequential":
            flush_print("\nRunning sequential bundle adjustment !")
            flush_print("Each date aligned with {} previous date(s)\n".format(self.n_dates))
            self.run_sequential_bundle_adjustment()
        elif self.ba_method == "ba_global":
            flush_print("\nRunning global bundle adjustment !")
            flush_print("Track pairs restricted to the same date and the next {} dates\n".format(
                self.n_dates))
            self.run_global_bundle_adjustment()
        elif self.ba_method == "ba_bruteforce":
            flush_print("\nRunning bruteforce bundle adjustment !")
            self.run_bruteforce_bundle_adjustment()
        else:
            print("ba_method {} is not valid !".format(self.ba_method))
            print("accepted values are: [ba_sequential, ba_global, ba_bruteforce]")
            sys.exit()


def load_pairs_from_same_date_and_next_dates(timeline, timeline_indices, next_dates=1):
    """Image pairs (i, j) of the images of the selected dates, in their
    order: every pair within a date, and every pair of a date with each of
    its next `next_dates` dates."""
    timeline_indices = [int(i) for i in timeline_indices]
    n_dates = len(timeline_indices)
    offsets = np.concatenate([[0], np.cumsum([timeline[t]["n_images"] for t in timeline_indices])])
    init_pairs = []
    for k, t_idx in enumerate(timeline_indices):
        n_img = timeline[t_idx]["n_images"]
        for i in range(n_img):
            for j in range(i + 1, n_img):
                init_pairs.append((int(offsets[k] + i), int(offsets[k] + j)))
        for dk in range(1, next_dates + 1):
            if k + dk >= n_dates:
                continue
            n_img2 = timeline[timeline_indices[k + dk]]["n_images"]
            for i in range(n_img):
                for j in range(n_img2):
                    init_pairs.append((int(offsets[k] + i), int(offsets[k + dk] + j)))
    return init_pairs
