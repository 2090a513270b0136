"""BundleAdjustmentPipeline: the 11-step chain on one device.

Counterpart of `sat_bundleadjust_tpu/pipeline.py`: (1) feature detection
(2) stereo pair selection (3) pairwise matching (4) track construction
(5) triangulation (6) track selection (optional) (7) parameter definition
(8) soft-L1 BA (9) outlier rejection (10) L2 BA (11) corrected-RPC fitting
and the outputs (rpcs/, rpcs_adj/, matches/, cam_params/, pts3d_adj.ply,
AOI.json, ba_figures/).

Detection, matching, triangulation, the LM solves and the RPC refit run on
`device` (default: the card); the orchestration and the files are host
code, as there. The camera models are rpc, affine and perspective (the
matrix models write P_adj/ and refit their .rpc_adj on the host); the
tracks come from the tracks front end or from a predefined-matches bundle
(in_dir/predefined_matches). With `distributed` (or a `mesh`) the BA
rounds solve over the ranks of the mesh (parallel/dist_solver.py), the
tracks front end splits its images and pairs over the processes, and rank
0 alone writes the outputs, behind barriers (parallel/multihost.py).
`timing` collects the seconds of every step of the last run, `ft_timing`
those of the tracks front end, `ft_counts` its images and pairs read from
the npy caches or computed, `ba_rounds` the counters of each LM solve and
`refit_stats` the refit's.
"""

import copy
import os
import shutil

import numpy as np

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.ba import outliers as ba_outliers
from sat_bundleadjust_tpu_torch.ba import rpcfit as ba_rpcfit
from sat_bundleadjust_tpu_torch.ba.params import BAParams
from sat_bundleadjust_tpu_torch.ba.solver import SOFT_L1_ROUND, BASolver, run_ba_optimization
from sat_bundleadjust_tpu_torch.models import cameras as cam_utils
from sat_bundleadjust_tpu_torch.models.ellipsoid import latlon_to_ecef_np
from sat_bundleadjust_tpu_torch.models.rpc import write_rpc_file
from sat_bundleadjust_tpu_torch.ops.triangulate import init_pts3d
from sat_bundleadjust_tpu_torch.parallel import multihost
from sat_bundleadjust_tpu_torch.parallel.mesh import make_mesh, world_size
from sat_bundleadjust_tpu_torch.tracks import build as ft_build
from sat_bundleadjust_tpu_torch.tracks import ranking as ft_ranking
from sat_bundleadjust_tpu_torch.utils import geo as geo_utils
from sat_bundleadjust_tpu_torch.utils import io as loader
from sat_bundleadjust_tpu_torch.utils.config import init_feature_tracks_config
from sat_bundleadjust_tpu_torch.utils.io import flush_print
from sat_bundleadjust_tpu_torch.utils.profiling import span


class Error(Exception):
    pass


class BundleAdjustmentPipeline:
    def __init__(self, ba_data, tracks_config=None, extra_ba_config=None, device=None):
        """ba_data holds "in_dir", "out_dir", "images" (SatelliteImage list)
        and optionally "cameras"; extra_ba_config the BA options of the
        scene config."""
        self.device = resolve_device(device)
        extra_ba_config = extra_ba_config or {}
        self.in_dir = ba_data["in_dir"]
        self.out_dir = ba_data["out_dir"]
        os.makedirs(self.out_dir, exist_ok=True)
        self.images = ba_data["images"]
        self.timing = {}

        self.tracks_config = init_feature_tracks_config(tracks_config or {})

        self.cam_model = extra_ba_config.get("cam_model", "rpc")
        if self.cam_model not in ["rpc", "affine", "perspective"]:
            raise Error("cam_model is not valid")
        self.aoi = extra_ba_config.get("aoi", None)
        self.n_adj = extra_ba_config.get("n_adj", 0)
        self.n_new = len(self.images) - self.n_adj
        self.correction_params = extra_ba_config.get("correction_params", ["R"])
        self.predefined_matches = extra_ba_config.get("predefined_matches", False)
        self.fix_ref_cam = extra_ba_config.get("fix_ref_cam", False)
        self.ref_cam_weight = extra_ba_config.get("ref_cam_weight", 1.0) if self.fix_ref_cam else 1.0
        self.clean_outliers = extra_ba_config.get("clean_outliers", True)
        self.outlier_thr_rounding = extra_ba_config.get("outlier_thr_rounding", False)
        self.max_init_reproj_error = extra_ba_config.get("max_init_reproj_error", None)
        self.save_figures = extra_ba_config.get("save_figures", True)
        # True / False / "auto": the BA rounds over the ranks of a mesh
        # (see _distributed_solve)
        self.distributed = extra_ba_config.get("distributed", "auto")
        self.mesh = extra_ba_config.get("mesh", None)
        if self.distributed is True or self.mesh is not None:
            from sat_bundleadjust_tpu_torch.parallel import mesh as mesh_lib

            if self.mesh is None:
                self.mesh = mesh_lib.make_mesh(device=self.device)
            # the feature stages and the solver follow the same ranks
            mesh_lib.set_default_mesh(self.mesh)
        self.dem_path = extra_ba_config.get("dem_path", None)

        from sat_bundleadjust_tpu_torch.utils.dem import make_alt_getter

        self.set_footprints(alt_getter=make_alt_getter(self.dem_path))
        if self.aoi is None:
            self.predefined_aoi = False
            self.aoi = loader.load_aoi_from_multiple_images(self.images)
        else:
            self.predefined_aoi = True

        with span("pipeline.cameras", self.timing, "cameras_s"):
            if "cameras" in ba_data:
                self.cameras = list(ba_data["cameras"])
            else:
                self.set_cameras()
            self.set_camera_centers()

        flush_print("Bundle Adjustment Pipeline created")
        flush_print("-------------------------------------------------------------")
        flush_print("    - input path:     {}".format(self.in_dir))
        flush_print("    - output path:    {}".format(self.out_dir))
        sq_km = geo_utils.measure_squared_km_from_lonlat_geojson(self.aoi)
        flush_print("    - aoi area:       {:.2f} squared km".format(sq_km))
        flush_print("    - input cameras:  {}".format(len(self.images)))
        flush_print("    - cam_model: {} / n_new: {} / n_adj: {}".format(self.cam_model, self.n_new, self.n_adj))
        flush_print("-------------------------------------------------------------\n")

        self.features = []
        self.pairs_to_triangulate = []
        self.C = None
        self.n_pts_fix = 0
        self.pts3d = None
        self.ba_params = None
        self.ba_e = None
        self.init_e = None
        self.ba_iters = 0
        self.corrected_cameras = None
        self.corrected_pts3d = None
        self.global_transform = None
        self.ft_timing = {}
        self.ft_counts = {}
        self.ba_rounds = []
        self.refit_stats = None

        # one writer of the shared outputs (every rank computes the same)
        if multihost.is_main_process():
            init_rpc_dir = os.path.join(self.out_dir, "rpcs")
            init_rpc_paths = ["{}/{}.rpc".format(init_rpc_dir, loader.get_id(im.geotiff_path))
                              for im in self.images]
            loader.save_rpcs(init_rpc_paths, [im.rpc for im in self.images])
        multihost.barrier("init_rpcs")

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def set_footprints(self, alt_getter=None):
        """Footprints at an altitude per image: alt_getter(image), else the
        clamped RPC altitude offset."""
        flush_print("Getting image footprints...")
        with span("pipeline.footprints", self.timing, "footprints_s"):
            for im in self.images:
                h = alt_getter(im) if alt_getter is not None else default_altitude(im.rpc)
                im.set_footprint(alt=h)
        flush_print("...done in {:.2f} seconds".format(self.timing["footprints_s"]))

    def set_camera_centers(self):
        """From a perspective fit of each RPC, or, for perspective cameras,
        from the cameras themselves."""
        flush_print("Estimating camera positions...")
        with span("pipeline.camera_centers") as wall:
            if self.cam_model != "perspective":
                for im in self.images:
                    if im.center is None:
                        im.set_camera_center()
            else:
                for im, cam in zip(self.images, self.cameras):
                    _, _, _, center = cam_utils.decompose_perspective_camera(cam)
                    im.set_camera_center(center=center)
        flush_print("...done in {:.2f} seconds".format(wall.seconds))

    def set_cameras(self):
        """The RPCs; or their affine approximations at the AOI centre (at
        altitude 0); or their perspective approximations over each crop."""
        if self.cam_model == "affine":
            lon, lat = self.aoi["center"]
            x, y, z = latlon_to_ecef_np(lat, lon, 0.0)
            self.cameras = [cam_utils.affine_rpc_approx(im.rpc, float(x), float(y), float(z),
                                                        im.offset)
                            for im in self.images]
        elif self.cam_model == "perspective":
            self.cameras = [cam_utils.perspective_rpc_approx(im.rpc, im.offset)[0]
                            for im in self.images]
        else:
            self.cameras = [copy.copy(im.rpc) for im in self.images]

    # ------------------------------------------------------------------
    # feature tracking
    # ------------------------------------------------------------------

    def compute_feature_tracks(self):
        """Tracks from the initial RPCs (in_dir/../rpcs_init when present),
        by the tracks front end or from the predefined-matches bundle in
        in_dir/predefined_matches; then the pair and correspondence checks.
        Cameras with too few tracks are dropped."""
        ft_images = [copy.copy(im) for im in self.images]
        init_rpc_dir = os.path.join(self.in_dir, "../rpcs_init")
        if os.path.exists(init_rpc_dir):
            ft_rpcs = loader.load_rpcs_from_dir(
                [im.geotiff_path for im in ft_images], init_rpc_dir, extension="rpc", verbose=False)
            for im, rpc in zip(ft_images, ft_rpcs):
                im.rpc = rpc
                im.set_footprint(alt=default_altitude(rpc))
        local_data = {"n_adj": self.n_adj, "images": ft_images, "aoi": self.aoi}
        output_dir = os.path.join(self.out_dir, "matches")
        if self.predefined_matches:
            from sat_bundleadjust_tpu_torch.tracks.predefined import (
                load_tracks_from_predefined_matches,
            )

            feature_tracks, self.feature_tracks_running_time = load_tracks_from_predefined_matches(
                os.path.join(self.in_dir, "predefined_matches"), output_dir, local_data,
                self.tracks_config)
        else:
            from sat_bundleadjust_tpu_torch.tracks.pipeline import FeatureTracksPipeline

            ft_pipeline = FeatureTracksPipeline(output_dir, output_dir, local_data,
                                                tracks_config=self.tracks_config,
                                                device=self.device)
            feature_tracks, self.feature_tracks_running_time = ft_pipeline.build_feature_tracks()
            self.ft_timing = dict(ft_pipeline.timing)
            self.ft_counts = dict(ft_pipeline.counts)

        new_camera_indices = np.arange(self.n_adj, len(self.images))
        fatal_error, err_msg, disconnected1 = ft_build.check_pairs(
            new_camera_indices, feature_tracks["pairs_to_match"], feature_tracks["pairs_to_triangulate"])
        if fatal_error:
            raise Error(err_msg)
        fatal_error, err_msg, disconnected2 = ft_build.check_correspondence_matrix(feature_tracks["C"])
        if fatal_error:
            raise Error(err_msg)
        disconnected = np.unique(disconnected1 + disconnected2).tolist()

        self.features = feature_tracks["features"]
        self.pairs_to_triangulate = feature_tracks["pairs_to_triangulate"]
        self.C = feature_tracks["C"]
        if self.cam_model == "rpc":  # the matrix cameras are of the crops
            for i in range(self.C.shape[0] // 2):
                self.C[2 * i, :] += self.images[i].offset["col0"]
                self.C[2 * i + 1, :] += self.images[i].offset["row0"]
        self.C_v2 = feature_tracks["C_v2"]
        self.n_pts_fix = feature_tracks["n_pts_fix"]

        if disconnected:
            self.drop_disconnected_cameras(disconnected)
            flush_print("Cameras {} were dropped due to insufficient feature tracks".format(disconnected))

    def initialize_pts3d(self):
        """One triangulated point per track, on the device."""
        self.pts3d = np.zeros((self.C.shape[1], 3))
        n_pts_opt = self.C.shape[1] - self.n_pts_fix
        if self.n_pts_fix > 0:
            flush_print("Initializing {} fixed 3d point coords...".format(self.n_pts_fix))
            with span("pipeline.pts3d_fix", tracks=self.n_pts_fix):
                C_fixed = self.C[: self.n_adj * 2, : self.n_pts_fix]
                self.pts3d[: self.n_pts_fix, :] = init_pts3d(
                    C_fixed, self.cameras, self.cam_model, self.pairs_to_triangulate,
                    device=self.device)
        flush_print("Initializing {} 3d point coords to optimize...".format(n_pts_opt))
        with span("pipeline.pts3d_opt") as wall:
            C_opt = self.C[:, -n_pts_opt:]
            self.pts3d[-n_pts_opt:, :] = init_pts3d(
                C_opt, self.cameras, self.cam_model, self.pairs_to_triangulate,
                device=self.device)
        flush_print("...done in {:.2f} seconds".format(wall.seconds))

    # ------------------------------------------------------------------
    # solver rounds
    # ------------------------------------------------------------------

    def define_ba_parameters(self, freeze_all_cams=False, verbose=True):
        cam_centers = [im.center for im in self.images]
        d = {
            "n_cam_fix": self.C.shape[0] // 2 if freeze_all_cams else self.n_adj,
            "n_pts_fix": self.n_pts_fix,
            "ref_cam_weight": self.ref_cam_weight,
            "correction_params": self.correction_params,
            "verbose": verbose,
        }
        self.ba_params = BAParams(self.C, self.pts3d, self.cameras, self.cam_model,
                                  self.pairs_to_triangulate, cam_centers, d)

    def _distributed_solve(self):
        """Resolve the `distributed` knob: True and False as given; "auto"
        means the distributed solve exactly when the world has more than
        one rank (one device per process: the JAX package's single-process
        "auto" over several devices has no counterpart here)."""
        if self.distributed is True or self.distributed is False:
            return self.distributed
        return world_size() > 1

    def _run_ba(self, ls_params, verbose=True):
        """One BA round on the device, or over the ranks of the mesh
        (parallel/dist_solver.run_ba_optimization_distributed, the same
        return contract); its solver counters go to `ba_rounds`. The solver
        (closures and tables, or this rank's shard) is kept while the
        BAParams instance is unchanged (rm_outliers returns the same object
        when nothing was removed)."""
        if self._distributed_solve():
            from sat_bundleadjust_tpu_torch.parallel.dist_solver import (
                make_distributed_solver,
                run_ba_optimization_distributed,
            )

            if self.mesh is None:
                self.mesh = make_mesh(device=self.device)
            if getattr(self, "_dist_solver_p", None) is not self.ba_params:
                self._dist_solver = make_distributed_solver(self.ba_params, ls_params,
                                                            mesh=self.mesh)
                self._dist_solver_p = self.ba_params
            out = run_ba_optimization_distributed(self.ba_params, ls_params, verbose=verbose,
                                                  mesh=self.mesh, solver=self._dist_solver)
            self.ba_rounds.append(dict(self._dist_solver.last_info))
            return out
        if getattr(self, "_ba_solver_p", None) is not self.ba_params:
            self._ba_solver = BASolver(self.ba_params, device=self.device)
            self._ba_solver_p = self.ba_params
        out = run_ba_optimization(self.ba_params, ls_params, verbose=verbose,
                                  solver=self._ba_solver)
        self.ba_rounds.append(dict(self._ba_solver.last_info))
        return out

    def run_ba_softL1(self):
        _, self.ba_sol, self.init_e, self.ba_e, iters = self._run_ba(SOFT_L1_ROUND, verbose=True)
        self.ba_iters += iters

    def run_ba_L2(self):
        _, self.ba_sol, self.init_e, self.ba_e, iters = self._run_ba(None, verbose=True)
        self.ba_iters += iters

    def clean_outlier_observations(self):
        with span("pipeline.outliers", self.timing, "outliers_s") as wall:
            self.ba_params = ba_outliers.rm_outliers(
                self.ba_e, self.ba_params, verbose=True,
                reference_rounding=self.outlier_thr_rounding, device=self.device)
        flush_print("Removal of outliers based on reprojection error took {:.2f} seconds".format(
            wall.seconds))

    def remove_all_obs_with_reprojection_error_higher_than(self, thr):
        print("\nAll observations with initial reprojection error higher than {} will be rejected !"
              .format(thr))
        self.define_ba_parameters(verbose=False)
        _, _, _, ba_e, _ = self._run_ba({"max_iter": 1, "verbose": 0}, verbose=False)
        p = ba_outliers.rm_outliers(ba_e, self.ba_params, predef_thr=thr, verbose=False,
                                    device=self.device)
        if p.n_cam != self.C.shape[0] // 2:
            raise Error("At least one camera was lost, there might be something wrong with the input images")
        self.C = ft_build.correspondence_matrix(p)
        self.pts3d = p.pts3d
        self.n_pts_fix = p.n_pts_fix
        self.C_v2 = self.C_v2[:, p.pts_prev_indices]
        self.C_v2[np.isnan(self.C[::2])] = np.nan

    # ------------------------------------------------------------------
    # track selection / camera management
    # ------------------------------------------------------------------

    def select_best_tracks(self, K=60, priority=("length", "scale", "cost")):
        if K <= 0:
            return
        C_scale = ft_ranking.compute_C_scale(self.C_v2, self.features)
        if self.pts3d is not None:
            cam_centers = [im.center for im in self.images]
            C_reproj = ft_ranking.compute_C_reproj(
                self.C, self.pts3d, self.cameras, self.cam_model,
                self.pairs_to_triangulate, cam_centers, device=self.device)
        else:
            C_reproj = np.zeros(C_scale.shape)

        true_if_new = np.sum(~np.isnan(self.C[::2, :])[-self.n_new:], axis=0).astype(bool)
        C_new = self.C[:, true_if_new]
        C_scale_new = C_scale[:, true_if_new]
        C_reproj_new = C_reproj[:, true_if_new]
        prev_indices = np.arange(len(true_if_new))[true_if_new]
        args = [C_new, C_scale_new, C_reproj_new, K, priority, True]
        if self.tracks_config["FT_skysat_sensor_aware"]:
            selected = ft_ranking.select_best_tracks_sensor_aware(self.images, *args)
        else:
            selected = ft_ranking.select_best_tracks(*args)
        selected = prev_indices[np.asarray(selected)]

        self.C = self.C[:, selected]
        self.C_v2 = self.C_v2[:, selected]
        self.n_pts_fix = int(len(selected[selected < self.n_pts_fix]))
        if self.pts3d is not None:
            self.pts3d = self.pts3d[selected, :]

    def check_connectivity_graph(self, min_matches=10):
        _, _, _, n_cc, _ = ft_build.build_connectivity_graph(self.C, min_matches=min_matches,
                                                             verbose=True)
        self.connectivity_graph_looks_good = n_cc <= 1
        if n_cc > 1:
            print("WARNING: Connectivity graph has {} connected components (min_matches = {})".format(
                n_cc, min_matches))

    def fix_reference_camera(self):
        """The camera with the most neighbours (then observations) becomes
        camera 0 and is frozen."""
        neighbor_nodes = np.sum(ft_build.build_connectivity_matrix(self.C, 10) > 0, axis=1)
        obs_per_cam = np.sum(~np.isnan(self.C), axis=1)[::2]
        n_cam = self.C.shape[0] // 2
        dtype = [("neighbor_nodes", int), ("obs", int)]
        values = np.array(list(zip(neighbor_nodes, obs_per_cam)), dtype=dtype)
        ref_cam_idx = int(np.argsort(values)[::-1][0])

        self.n_adj += 1
        self.n_new -= 1
        new_indices = np.arange(n_cam)
        new_indices[new_indices < ref_cam_idx] += 1
        new_indices[ref_cam_idx] = 0
        cam_indices = np.vstack([new_indices, np.arange(n_cam)]).T
        self.permute_cameras(cam_indices)
        flush_print("Using input image {} as reference image of the set".format(ref_cam_idx))
        flush_print("Reference geotiff: {}".format(self.images[0].geotiff_path))

    def permute_cameras(self, cam_indices):
        order = sorted(cam_indices.tolist(), key=lambda x: x[0])

        def rearange(lst):
            return [lst[old] for _, old in order]

        self.C = np.vstack([self.C[2 * old: 2 * old + 2] for _, old in order])
        self.C_v2 = np.vstack([self.C_v2[old: old + 1] for _, old in order])

        remap = dict(zip(cam_indices[:, 1].tolist(), cam_indices[:, 0].tolist()))
        new_pairs = []
        for (a, b) in self.pairs_to_triangulate:
            if a in remap and b in remap:
                na, nb = remap[a], remap[b]
                new_pairs.append((min(na, nb), max(na, nb)))
        self.pairs_to_triangulate = new_pairs
        self.images = rearange(self.images)
        self.cameras = rearange(self.cameras)
        if self.features:
            self.features = rearange(self.features)

    def drop_disconnected_cameras(self, camera_indices_to_drop):
        n_before = len(self.images)
        left = np.sort(list(set(range(n_before)) - set(camera_indices_to_drop)))
        cam_indices = np.vstack([np.arange(len(left)), left]).T
        self.n_adj -= int(np.sum(np.array(camera_indices_to_drop) < self.n_adj))
        self.n_new -= int(np.sum(np.array(camera_indices_to_drop) >= self.n_adj))
        self.permute_cameras(cam_indices)

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    def correct_drift_object_space(self):
        """Global translation = mean(pts_after - pts_before)."""
        self.global_transform = np.mean(self.ba_params.pts3d_ba - self.ba_params.pts3d, axis=0)
        flush_print("Global transform to correct drift in object space successfully computed.")

    def save_corrected_points(self):
        path = os.path.join(self.out_dir, "pts3d_adj.ply")
        pts = self.ba_params.pts3d_ba.copy()
        if self.global_transform is not None:
            pts -= self.global_transform
        loader.write_point_cloud_ply(path, pts)
        flush_print("Bundle adjusted 3d points written at {}\n".format(path))

    def save_estimated_params(self):
        for cam_idx, cam_prev_idx in enumerate(self.ba_params.cam_prev_indices):
            cam_id = loader.get_id(self.images[cam_prev_idx].geotiff_path)
            fname = "{}/cam_params/{}.params".format(self.out_dir, cam_id)
            os.makedirs(os.path.dirname(fname), exist_ok=True)
            with open(fname, "w") as f:
                for k, v in self.ba_params.estimated_params[cam_idx].items():
                    f.write("{}\n".format(k))
                    f.write(" ".join(["{:.16f}".format(x) for x in np.atleast_1d(v)]))
                    f.write("\n")
        flush_print("All estimated camera parameters written at {}/cam_params\n".format(self.out_dir))

    def _points_seen_by(self, cam_idx):
        """The adjusted points of the tracks that camera cam_idx of the BA
        problem observes, in track order."""
        p = self.ba_params
        return p.pts3d_ba[p.pts_ind[p.cam_ind == cam_idx]]

    def save_corrected_rpcs(self):
        """rpc: the adjusted cameras' RPCs, refit in one batched program per
        margin round on the device, and the already adjusted ones as they
        are. Matrix models: every camera's RPC refit to its corrected
        matrix, one camera at a time on the host."""
        out_dir = os.path.join(self.out_dir, "rpcs_adj")
        fnames = [os.path.join(out_dir, loader.get_id(im.geotiff_path) + ".rpc_adj")
                  for im in self.images]
        if self.cam_model in ["perspective", "affine"]:
            self._save_rpcs_of_matrices(fnames)
            flush_print("Bundle adjusted rpcs written at {}\n".format(out_dir))
            return
        for cam_idx in range(self.n_adj):
            write_rpc_file(self.cameras[cam_idx], fnames[cam_idx])
        cam_prev = list(self.ba_params.cam_prev_indices)
        new_indices = list(range(self.n_adj, self.n_adj + self.n_new))
        pts_seen = [self._points_seen_by(cam_prev.index(c)) for c in new_indices]
        self.refit_stats = {}
        with span("pipeline.refit", self.timing, "refit_s"):
            results = ba_rpcfit.fit_rpcs_batched(
                [np.asarray(self.corrected_cameras[c]).reshape(9) for c in new_indices],
                self.global_transform,
                [self.cameras[c] for c in new_indices],
                [self.images[c].offset for c in new_indices],
                pts_seen, device=self.device, stats=self.refit_stats)
        self.refit_stats["fit_error_max"] = [float(err.max()) for _, err, _ in results]
        self.refit_stats["fit_error_median"] = [float(np.median(err)) for _, err, _ in results]
        self.refit_stats["margins"] = [margin for _, _, margin in results]
        for cam_idx, (rpc_calib, err, margin) in zip(new_indices, results):
            flush_print("cam {:2} - RPC fit error per obs [1e-4 px] max / med: {:.2f} / {:.2f} (margin {})"
                        .format(cam_idx, 1e4 * err.max(), 1e4 * np.median(err), margin))
            write_rpc_file(rpc_calib, fnames[cam_idx])
        flush_print("Bundle adjusted rpcs written at {}\n".format(out_dir))

    def _save_rpcs_of_matrices(self, fnames):
        results = []
        with span("pipeline.refit", self.timing, "refit_s"):
            for cam_idx, (fn, cam) in enumerate(zip(fnames, self.corrected_cameras)):
                pts_seen = self._points_seen_by(cam_idx)
                rpc_calib, err, margin = ba_rpcfit.fit_rpc_from_projection_matrix(
                    cam, self.global_transform, self.images[cam_idx].rpc,
                    self.images[cam_idx].offset, pts_seen)
                flush_print("cam {:2} - RPC fit error per obs [1e-4 px] max / med: {:.2f} / {:.2f} "
                            "(margin {})".format(cam_idx, 1e4 * err.max(), 1e4 * np.median(err),
                                                 margin))
                write_rpc_file(rpc_calib, fn)
                results.append((err, margin))
        self.refit_stats = {
            "fit_error_max": [float(err.max()) for err, _ in results],
            "fit_error_median": [float(np.median(err)) for err, _ in results],
            "margins": [margin for _, margin in results],
        }

    def save_initial_matrices(self):
        """The initial projection matrices, as P_init/<id>_pinhole.json."""
        out_dir = os.path.join(self.out_dir, "P_init")
        fnames = [os.path.join(out_dir, loader.get_id(im.geotiff_path) + "_pinhole.json")
                  for im in self.images]
        loader.save_projection_matrices(fnames, self.cameras, [im.offset for im in self.images])
        flush_print("\nInitial projection matrices written at {}\n".format(out_dir))

    def save_corrected_matrices(self):
        """The corrected projection matrices, as P_adj/<id>_pinhole_adj.json."""
        out_dir = os.path.join(self.out_dir, "P_adj")
        fnames = [os.path.join(out_dir, loader.get_id(im.geotiff_path) + "_pinhole_adj.json")
                  for im in self.images]
        loader.save_projection_matrices(fnames, self.corrected_cameras,
                                        [im.offset for im in self.images])

    def save_corrected_cameras(self):
        if self.cam_model in ["perspective", "affine"]:
            self.save_corrected_matrices()
        flush_print("Fitting corrected RPC models...")
        self.save_corrected_rpcs()

    def save_feature_tracks(self):
        """Per-image SVG with the track observations."""
        from sat_bundleadjust_tpu_torch.utils.viz import save_pts2d_as_svg

        p = self.ba_params
        for cam_idx, cam_prev_idx in enumerate(p.cam_prev_indices):
            cam_id = loader.get_id(self.images[cam_prev_idx].geotiff_path)
            svg_fname = "{}/ba_figures/track_obs/{}.svg".format(self.out_dir, cam_id)
            pts2d = p.pts2d[p.cam_ind == cam_idx]
            offset = self.images[cam_prev_idx].offset
            if self.cam_model == "rpc":
                pts2d[:, 0] -= offset["col0"]
                pts2d[:, 1] -= offset["row0"]
            save_pts2d_as_svg(svg_fname, pts2d, c="yellow", w=offset["width"], h=offset["height"])

    def save_debug_figures(self):
        from sat_bundleadjust_tpu_torch.utils import viz

        footprints = [im.lonlat_geojson for im in self.images]
        viz.draw_image_footprints(
            os.path.join(self.out_dir, "ba_figures/image_footprints_and_aoi.png"), footprints, self.aoi)
        viz.save_connectivity_graph(
            os.path.join(self.out_dir, "ba_figures/connectivity_graph.png"),
            ft_build.correspondence_matrix(self.ba_params), min_matches=0)
        viz.save_histogram_of_errors(
            os.path.join(self.out_dir, "ba_figures/error_histograms.png"), self.init_e, self.ba_e)
        aoi_roi = self.aoi if self.predefined_aoi else None
        for tag, err in (("before", self.init_e), ("after", self.ba_e)):
            viz.save_heatmap_of_reprojection_error(
                os.path.join(self.out_dir, "ba_figures/error_{}.png".format(tag)),
                self.ba_params, err, footprints, aoi_roi, global_transform=self.global_transform)

    # ------------------------------------------------------------------

    def run(self):
        """The full chain; the seconds of each step go to `timing`."""
        with span("pipeline.run") as wall:
            self._run()
        flush_print("\nBundle adjustment pipeline completed in {}\n".format(
            loader.get_time_in_hours_mins_secs(wall.seconds)))

    def _run(self):
        def timed(key, fn, *args):
            with span("pipeline." + key[:-2], self.timing, key):
                return fn(*args)

        timed("tracks_s", self.compute_feature_tracks)
        timed("triangulation_s", self.initialize_pts3d)

        if not self.tracks_config["FT_save"]:
            # several processes: every rank is done with the npy caches
            # before one removes them
            multihost.barrier("tracks_done")
            if multihost.is_main_process():
                shutil.rmtree(os.path.join(self.out_dir, "matches"), ignore_errors=True)

        if self.max_init_reproj_error is not None:
            self.remove_all_obs_with_reprojection_error_higher_than(thr=self.max_init_reproj_error)

        with span("pipeline.selection", self.timing, "selection_s"):
            self.check_connectivity_graph(min_matches=5)
            if self.connectivity_graph_looks_good:
                self.select_best_tracks(K=self.tracks_config["FT_K"],
                                        priority=self.tracks_config["FT_priority"])
                self.check_connectivity_graph(min_matches=5)
            ft_ranking.print_quick_camera_weights([im.geotiff_path for im in self.images], self.C)
            if self.fix_ref_cam:
                self.fix_reference_camera()
        with span("pipeline.optimization") as optimization:
            timed("parameters_s", self.define_ba_parameters, False, True)
            if self.clean_outliers:
                timed("soft_l1_s", self.run_ba_softL1)
                self.clean_outlier_observations()
            timed("l2_s", self.run_ba_L2)
            cam_sol, pts_sol = self.ba_sol
            self.corrected_pts3d, self.corrected_cameras = self.ba_params.reconstruct_vars(
                cam_sol, pts_sol, self.pts3d, self.cameras)
        flush_print("Optimization problem solved in {} ({} iterations)\n".format(
            loader.get_time_in_hours_mins_secs(optimization.seconds), self.ba_iters))

        if self.n_adj == 0:
            self.correct_drift_object_space()
        else:
            self.global_transform = None

        # the outputs: one writer; the barrier makes them visible to every
        # rank (the sequential mode's next date reads the adjusted RPCs)
        if multihost.is_main_process():
            with span("pipeline.outputs") as outputs:
                self.save_corrected_points()
                self.save_estimated_params()
                self.save_corrected_cameras()
            self.timing["writes_s"] = outputs.seconds - self.timing["refit_s"]

            if self.save_figures:
                with span("pipeline.figures", self.timing, "figures_s"):
                    loader.save_geojson(os.path.join(self.out_dir, "AOI.json"), self.aoi)
                    self.save_feature_tracks()
                    self.save_debug_figures()
        multihost.barrier("pipeline_outputs")


def default_altitude(rpc):
    """Terrain altitude without a DEM: the RPC altitude offset, clamped to
    plausible terrain values."""
    return float(np.clip(float(np.asarray(rpc.alt_offset)), -400.0, 8800.0))
