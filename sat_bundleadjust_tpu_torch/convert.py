"""Carry problem state in from numpy arrays.

Turns state held as numpy arrays — for instance pulled out of the JAX
package's objects — into the port's objects:
  * stacked RPC coefficients and offsets (RPCModel field order, leading dim
    M) into a batched RPCModel of tensors, or a list of per-camera models;
  * a BA problem's observation table, camera parameters, tie points, masks
    and triangulation pairs into a BAParams, for the rpc model (stacked RPC
    fields) or a matrix model (stacked 3x4 cameras).
This module imports neither the JAX package nor JAX.
"""

import numpy as np
import torch

from sat_bundleadjust_tpu_torch.ba.params import BAParams
from sat_bundleadjust_tpu_torch.models.rpc import RPCModel


def _rpc_fields(fields):
    if isinstance(fields, dict):
        fields = [fields[name] for name in RPCModel._fields]
    fields = [np.asarray(f, np.float64) for f in fields]
    if len(fields) != len(RPCModel._fields):
        raise ValueError("expected {} RPC fields, got {}".format(len(RPCModel._fields), len(fields)))
    return fields


def rpcs_from_arrays(fields, device):
    """Batched RPCModel of float64 tensors on device from stacked numpy
    fields (a sequence in RPCModel order, or a dict by field name)."""
    return RPCModel(*[torch.as_tensor(f, device=device) for f in _rpc_fields(fields)])


def rpc_list_from_arrays(fields):
    """Per-camera RPCModels (numpy fields) from stacked numpy fields."""
    fields = _rpc_fields(fields)
    return [RPCModel(*[f[i] for f in fields]) for i in range(fields[0].shape[0])]


def baparams_from_arrays(state):
    """A BAParams from a dict of numpy arrays:

      cam_model: "rpc" (default), "affine" or "perspective";
      rpcs: stacked RPC fields (M leading), for "rpc";
      cameras: (M, 3, 4) matrices and camera_centers (M, 3), for the
      matrix models;
      cam_params (M, F), pts3d (N, 3);
      pts_ind, cam_ind (K,), pts2d (K, 2), pts2d_w (K,);
      cam_opt_mask (M,), pts_opt_mask (N,);
      pairs_to_triangulate: (Q, 2) camera pairs;
      correction_params: list such as ["R"] or ["R", "T", "K", "COMMON_K"];
      optional: pts_prev_indices, cam_prev_indices, ref_cam_weight.
    """
    p = BAParams.__new__(BAParams)
    p.cam_model = state.get("cam_model", "rpc")
    p.pts3d = np.array(state["pts3d"], np.float64)
    p.cam_params = np.array(state["cam_params"], np.float64)
    if p.cam_model == "rpc":
        p.cameras = rpc_list_from_arrays(state["rpcs"])
        p.camera_centers = [c for c in p.cam_params[:, 6:9]]
    else:
        p.cameras = [np.array(c, np.float64) for c in state["cameras"]]
        p.camera_centers = [np.array(c, np.float64) for c in state["camera_centers"]]
    p.pairs_to_triangulate = [(int(a), int(b)) for a, b in state["pairs_to_triangulate"]]
    p.cam_params_to_optimize = list(state["correction_params"])
    p.ref_cam_weight = float(state.get("ref_cam_weight", 1.0))
    p.verbose = False

    cam_opt_mask = np.asarray(state["cam_opt_mask"], np.float64)
    pts_opt_mask = np.asarray(state["pts_opt_mask"], np.float64)
    p.n_cam, p.n_pts = len(cam_opt_mask), len(pts_opt_mask)
    p.n_cam_fix = int(np.sum(cam_opt_mask == 0))
    p.n_pts_fix = int(np.sum(pts_opt_mask == 0))
    p.n_cam_opt = p.n_cam - p.n_cam_fix
    p.n_pts_opt = p.n_pts - p.n_pts_fix
    p.cam_prev_indices = np.asarray(state.get("cam_prev_indices", np.arange(p.n_cam)))
    p.pts_prev_indices = np.asarray(state.get("pts_prev_indices", np.arange(p.n_pts)))

    p.pts_ind = np.asarray(state["pts_ind"], np.int32)
    p.cam_ind = np.asarray(state["cam_ind"], np.int32)
    p.pts2d = np.asarray(state["pts2d"], np.float64)
    p.n_obs = p.pts2d.shape[0]
    p.pts2d_w = np.asarray(state["pts2d_w"], np.float64)

    p._set_param_layout()
    p.cam_opt_mask = cam_opt_mask
    p.pts_opt_mask = pts_opt_mask
    return p
