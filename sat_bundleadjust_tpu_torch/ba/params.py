"""Bundle adjustment parameterization.

Counterpart of `sat_bundleadjust_tpu/ba/params.py`. Turns the pipeline's
problem description (correspondence matrix C, initial tie points, cameras)
into the flat observation table the solver consumes, and back. This is
host-side bookkeeping in numpy; the solver moves what it needs to the
device.

Camera parameter layouts per model:
  rpc:         [euler (3), T (3), C (3)]                (9): a corrective
               rotation and translation about the fixed camera center C;
  affine:      [euler (3), T (2), fx, fy, skew]         (8);
  perspective: [euler (3), T (3), fx, fy, skew, cx, cy] (11).
The optimized prefix holds R, then T, then K, as correction_params asks.
"""

import numpy as np
import torch

from sat_bundleadjust_tpu_torch.models import cameras as cam_utils
from sat_bundleadjust_tpu_torch.models.rotations import euler_angles_from_R, euler_angles_to_R
from sat_bundleadjust_tpu_torch.models.rpc import stack_rpcs
from sat_bundleadjust_tpu_torch.utils.profiling import span


def load_cam_params_from_camera(camera, camera_center, cam_model):
    """Per-camera parameter vector: the rpc correction starts at identity;
    a matrix camera is decomposed into its angles, translation and
    intrinsics."""
    if cam_model == "affine":
        K, R, vecT = cam_utils.decompose_affine_camera(camera)
        vecR = np.array(euler_angles_from_R(R), dtype=np.float64)
        fx, fy, skew = K[0, 0], K[1, 1], K[0, 1]
        return np.hstack((vecR.ravel(), np.asarray(vecT).ravel(), fx, fy, skew))
    if cam_model == "perspective":
        K, R, vecT, _ = cam_utils.decompose_perspective_camera(camera)
        K = K / K[2, 2]
        vecR = np.array(euler_angles_from_R(R), dtype=np.float64)
        fx, fy, skew, cx, cy = K[0, 0], K[1, 1], K[0, 1], K[0, 2], K[1, 2]
        return np.hstack((vecR.ravel(), np.asarray(vecT).ravel(), fx, fy, skew, cx, cy))
    return np.hstack((np.zeros(6), np.asarray(camera_center, np.float64).ravel()))


def _R_from_angles(vecR):
    return euler_angles_to_R(*torch.as_tensor(np.asarray(vecR, np.float64))).numpy()


def load_camera_from_cam_params(cam_params, cam_model):
    """The camera of a parameter vector: a 3x4 matrix (normalized to
    P[2, 3] = 1) for the matrix models, the (1, 9) vector for rpc."""
    cam_params = np.asarray(cam_params)
    if cam_model == "affine":
        vecR, vecT = cam_params[0:3], cam_params[3:5]
        fx, fy, skew = cam_params[5], cam_params[6], cam_params[7]
        K = np.array([[fx, skew], [0, fy]])
        P = cam_utils.compose_affine_camera(K, _R_from_angles(vecR), vecT)
        return P / P[2, 3]
    if cam_model == "perspective":
        vecR, vecT = cam_params[0:3], cam_params[3:6]
        fx, fy, skew = cam_params[6], cam_params[7], cam_params[8]
        cx, cy = cam_params[9], cam_params[10]
        K = np.array([[fx, skew, cx], [0, fy, cy], [0, 0, 1]])
        P = K @ np.hstack((_R_from_angles(vecR), vecT.reshape(3, 1)))
        return P / P[2, 3]
    return cam_params.reshape(1, 9)


def point_major_order(pts_ind, cam_ind):
    """np.lexsort((cam_ind, pts_ind)): the stable order of the observations
    by (point, camera), as one stable sort (torch's, on the host's threads)
    of the key point * S + camera - min(camera), S the cameras' span, in
    int32 where it fits (that sort is the faster), else in int64."""
    pts = torch.as_tensor(np.asarray(pts_ind, np.int64))
    cam = torch.as_tensor(np.asarray(cam_ind, np.int64))
    if cam.numel() == 0:
        return np.zeros(0, np.int64)
    low, high = torch.aminmax(cam)
    key = pts * (high - low + 1) + (cam - low)
    low, high = torch.aminmax(key)
    if -2**31 <= low and high < 2**31:
        key = key.int()
    return torch.sort(key, stable=True).indices.numpy()


class BAParams:
    """The bundle adjustment problem state: the observation table in
    point-major (point, camera) order, the cameras' parameters and the
    problem's layout.

    Args:
      C: (2M, N) correspondence matrix (NaN where unobserved), the tracks
         layer's format: read once into the table
      pts3d: (N, 3) initial ECEF tie points
      cameras: list of M RPCModel (numpy fields) or 3x4 matrices
      cam_model: "rpc" | "affine" | "perspective"
      pairs_to_triangulate: list of camera index pairs
      camera_centers: list of (3,) arrays
      d: optional dict with n_cam_fix, n_pts_fix, reduce, verbose,
         correction_params (subset of R/T/K/COMMON_K), ref_cam_weight
    """

    def __init__(self, C, pts3d, cameras, cam_model, pairs_to_triangulate, camera_centers, d=None):
        d = {"verbose": True, "reduce": True, **(d or {})}
        C = np.asarray(C, dtype=np.float64)
        # C's observations, point by point and camera by camera within a point
        pts_ind, cam_ind = np.nonzero(~np.isnan(C[::2]).T)
        pts2d = np.stack([C[2 * cam_ind, pts_ind], C[2 * cam_ind + 1, pts_ind]], axis=1)
        self._define(pts_ind, cam_ind, pts2d, pts3d, cameras, cam_model, camera_centers,
                     pairs_to_triangulate, d)
        if self.verbose:
            self.print_definition()

    @classmethod
    def from_obs_table(cls, pts_ind, cam_ind, pts2d, pts3d, cameras, cam_model,
                       camera_centers, pairs_to_triangulate=None, d=None):
        """Construction from a flat observation table in any order. The
        table is sorted to point-major order, so that it gives the problem
        of the C matrix with the same observations. No reduce pass: callers
        pass tables in which every track is observed by an optimizable
        camera."""
        with span("ba.params", observations=len(pts_ind)):
            self = cls.__new__(cls)
            with span("ba.params.sort"):
                order = torch.from_numpy(point_major_order(pts_ind, cam_ind))
                pts_ind, cam_ind, pts2d = (
                    torch.from_numpy(np.ascontiguousarray(a, dtype)).index_select(0, order).numpy()
                    for a, dtype in ((pts_ind, np.int32), (cam_ind, np.int32),
                                     (pts2d, np.float64)))
            self._define(pts_ind, cam_ind, pts2d, pts3d, cameras, cam_model, camera_centers,
                         pairs_to_triangulate or [],
                         {"verbose": False, **(d or {}), "reduce": False})
            return self

    def _define(self, pts_ind, cam_ind, pts2d, pts3d, cameras, cam_model, camera_centers,
                pairs_to_triangulate, d):
        """Both constructors' set-up from a point-major table."""
        self.pts3d = np.array(pts3d, dtype=np.float64)
        self.cameras = list(cameras)
        self.cam_model = cam_model
        self.pairs_to_triangulate = list(pairs_to_triangulate)
        self.camera_centers = [np.asarray(c) for c in camera_centers]

        self.cam_params_to_optimize = d.get("correction_params", ["R"])
        self.ref_cam_weight = float(d.get("ref_cam_weight", 1.0))
        self.n_cam_fix = int(d.get("n_cam_fix", 0))
        self.n_pts_fix = int(d.get("n_pts_fix", 0))
        self.verbose = bool(d["verbose"])

        self.pts_ind = np.asarray(pts_ind).astype(np.int32, copy=False)
        self.cam_ind = np.asarray(cam_ind).astype(np.int32, copy=False)
        self.pts2d = np.asarray(pts2d, dtype=np.float64)
        self.n_cam, self.n_pts = len(self.cameras), int(self.pts3d.shape[0])
        self.cam_prev_indices = np.arange(self.n_cam)
        self.pts_prev_indices = np.arange(self.n_pts)
        if d["reduce"]:
            self._reduce()
        self.n_cam_opt = self.n_cam - self.n_cam_fix
        self.n_pts_opt = self.n_pts - self.n_pts_fix
        self.n_obs = self.pts2d.shape[0]

        with span("ba.params.cameras", cameras=len(self.cameras)):
            self.cam_params = np.array(
                [load_cam_params_from_camera(c, oC, cam_model)
                 for c, oC in zip(self.cameras, self.camera_centers)]
            )

        # camera 0 may be a weighted reference camera
        self.pts2d_w = np.ones(self.n_obs)
        if self.ref_cam_weight > 1.0:
            self.pts2d_w[self.cam_ind == 0] = self.ref_cam_weight

        self._set_param_layout()

    def _reduce(self):
        """Drop the tracks with no observation in the optimized cameras,
        then the cameras left with no observation, from the table; what is
        kept keeps its order (pts_prev_indices, cam_prev_indices)."""
        tracks = np.bincount(self.pts_ind[self.cam_ind >= self.n_cam_fix],
                             minlength=self.n_pts) > 0
        self.pts_prev_indices = np.flatnonzero(tracks)
        self.n_pts_fix -= int(np.sum(~tracks[: self.n_pts_fix]))
        self.pts3d = self.pts3d[self.pts_prev_indices]
        rows = tracks[self.pts_ind]
        self.pts_ind = (np.cumsum(tracks) - 1)[self.pts_ind[rows]].astype(np.int32)
        self.cam_ind, self.pts2d = self.cam_ind[rows], self.pts2d[rows]

        cams = np.bincount(self.cam_ind, minlength=self.n_cam) > 0
        new_idx = np.cumsum(cams) - 1
        self.cam_prev_indices = np.flatnonzero(cams)
        self.n_cam_fix -= int(np.sum(~cams[: self.n_cam_fix]))
        self.cam_ind = new_idx[self.cam_ind].astype(np.int32)
        self.cameras = [self.cameras[i] for i in self.cam_prev_indices]
        self.camera_centers = [self.camera_centers[i] for i in self.cam_prev_indices]
        self.pairs_to_triangulate = [
            (int(new_idx[a]), int(new_idx[b])) for (a, b) in self.pairs_to_triangulate
            if a < len(cams) and b < len(cams) and cams[a] and cams[b]]
        self.n_cam, self.n_pts = len(self.cam_prev_indices), len(self.pts_prev_indices)

    def print_definition(self):
        """The problem's sizes, as the constructor prints them when verbose."""
        print("\nDefining bundle adjustment parameters...")
        print("     - cam_params_to_optimize: {}".format(self.cam_params_to_optimize))
        print("{} 3d points, {} fixed and {} to be optimized".format(self.n_pts, self.n_pts_fix, self.n_pts_opt))
        print("{} cameras, {} fixed and {} to be optimized".format(self.n_cam, self.n_cam_fix, self.n_cam_opt))
        print("{} parameters to optimize per camera\n".format(self.n_params))

    def _set_param_layout(self):
        """Number of optimized parameters, COMMON_K's seeding, frozen-entity
        masks and the stacked RPCs; after the table."""
        affine = self.cam_model == "affine"
        n_params = 0
        self.n_params_k = 0
        if "R" in self.cam_params_to_optimize:
            n_params += 3
            if "T" in self.cam_params_to_optimize:
                n_params += 2 if affine else 3
                if "K" in self.cam_params_to_optimize:
                    self.n_params_k = 3 if affine else 5
                    n_params += self.n_params_k
        self.n_params = n_params
        # COMMON_K: one K for every camera. It stays in each camera's row,
        # seeded from camera 0; the solver's tied-tail projection
        # (ops/lm.LMConfig.tie_tail) keeps the optimized cameras' K equal.
        # Frozen cameras keep their (equally seeded) K and do not drive it.
        self.common_k = self.n_params_k > 0 and "COMMON_K" in self.cam_params_to_optimize
        if self.common_k:
            k0, k1 = self.n_params - self.n_params_k, self.n_params
            self.cam_params[:, k0:k1] = self.cam_params[0, k0:k1]

        self.cam_opt_mask = np.ones(self.n_cam)
        self.cam_opt_mask[: self.n_cam_fix] = 0.0
        self.pts_opt_mask = np.ones(self.n_pts)
        self.pts_opt_mask[: self.n_pts_fix] = 0.0

        # host copy of the batched RPCs; the solver moves it to its device
        with span("ba.params.stack_rpcs"):
            self.rpcs = stack_rpcs(self.cameras, "cpu") if self.cam_model == "rpc" else None

        self.pts3d_ba = None
        self.cameras_ba = None
        self.estimated_params = None

    def opt_block(self):
        """Initial optimized camera block (M, n_params)."""
        return self.cam_params[:, : self.n_params].copy()

    def full_cam_params(self, cam_opt):
        """Optimized prefix + constant tail -> (M, F)."""
        return np.hstack([np.asarray(cam_opt), self.cam_params[:, self.n_params:]])

    def reconstruct_vars(self, cam_opt, pts3d_ba, pts3d_init, cameras_init):
        """Camera models and corrected points from the solution, in the
        original (pre-reduce) indexing: (corrected_pts3d, corrected_cameras).
        cam_opt and pts3d_ba may be tensors on any device."""
        with span("ba.reconstruct", points=len(self.pts_prev_indices)):
            with span("ba.reconstruct.to_host"):
                cam_params = self.full_cam_params(_to_numpy(cam_opt))
                self.pts3d_ba = _to_numpy(pts3d_ba)
            with span("ba.reconstruct.cameras"):
                self.cameras_ba = [load_camera_from_cam_params(cam_params[i], self.cam_model)
                                   for i in range(self.n_cam)]
                self.estimated_params = []
                for i in range(self.n_cam):
                    est = {}
                    if "R" in self.cam_params_to_optimize:
                        est["R"] = cam_params[i, :3]
                    if "T" in self.cam_params_to_optimize:
                        est["T"] = cam_params[i, 3:6]
                    if self.cam_model == "rpc":
                        est["C"] = cam_params[i, 6:9]
                    self.estimated_params.append(est)

            with span("ba.reconstruct.points"):
                corrected_pts3d = np.array(pts3d_init, dtype=np.float64, copy=True)
                corrected_pts3d[self.pts_prev_indices] = self.pts3d_ba
            corrected_cameras = list(cameras_init)
            for ba_idx, prev_idx in enumerate(self.cam_prev_indices):
                corrected_cameras[prev_idx] = self.cameras_ba[ba_idx]
        return corrected_pts3d, corrected_cameras


def _to_numpy(a):
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)
