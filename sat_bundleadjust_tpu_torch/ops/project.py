"""Batched reprojection of tie points through corrected camera models.

Counterpart of `sat_bundleadjust_tpu/ops/project.py`. Camera parameter
layouts (ba/params.load_cam_params_from_camera):

* rpc:         [euler (3), T (3), C (3)]                -> 9 values; the
  correction is X' = R(X - T - C) + C, then the original RPC projects X';
* affine:      [euler (3), T (2), fx, fy, skew]         -> 8 values;
* perspective: [euler (3), T (3), fx, fy, skew, cx, cy] -> 11 values.
"""

import torch

from sat_bundleadjust_tpu_torch.models import ellipsoid
from sat_bundleadjust_tpu_torch.models.rotations import rotate_euler
from sat_bundleadjust_tpu_torch.models.rpc import index_rpc, rpc_projection

CAM_PARAMS_SIZE = {"rpc": 9, "affine": 8, "perspective": 11}


def adjust_pts3d(pts3d, rt_vec):
    """X' = R(X - T - C) + C. pts3d: (..., 3); rt_vec: (..., 9)."""
    adj = pts3d - rt_vec[..., 3:6] - rt_vec[..., 6:9]
    adj = rotate_euler(adj, rt_vec[..., :3])
    return adj + rt_vec[..., 6:9]


def project_rpc(pts3d, rpcs, cam_params, pts_ind, cam_ind):
    """(K, 2) projected (col, row) of tie points pts3d (N, 3) through
    batched RPCs (leading dim M) corrected by cam_params (M, 9)."""
    Xadj = adjust_pts3d(pts3d[pts_ind], cam_params[cam_ind])
    lat, lon, alt = ellipsoid.ecef_to_latlon(Xadj[..., 0], Xadj[..., 1], Xadj[..., 2])
    col, row = rpc_projection(index_rpc(rpcs, cam_ind), lon, lat, alt)
    return torch.stack([col, row], dim=-1)


def affine_from_params(pts, camv):
    """The affine projection of points (..., 3) by parameter rows (..., 8)."""
    p = rotate_euler(pts, camv[..., :3])
    x = p[..., 0] + camv[..., 3]
    y = p[..., 1] + camv[..., 4]
    return torch.stack([camv[..., 5] * x + camv[..., 7] * y, camv[..., 6] * y], dim=-1)


def perspective_from_params(pts, camv):
    """The perspective projection of points (..., 3) by parameter rows
    (..., 11)."""
    p = rotate_euler(pts, camv[..., :3]) + camv[..., 3:6]
    fx, fy, skew = camv[..., 6], camv[..., 7], camv[..., 8]
    cx, cy = camv[..., 9], camv[..., 10]
    u = fx * p[..., 0] + skew * p[..., 1] + cx * p[..., 2]
    v = fy * p[..., 1] + cy * p[..., 2]
    return torch.stack([u / p[..., 2], v / p[..., 2]], dim=-1)


def project_affine(pts3d, cam_params, pts_ind, cam_ind):
    """(K, 2) affine projections of the observations' points."""
    return affine_from_params(pts3d[pts_ind], cam_params[cam_ind])


def project_perspective(pts3d, cam_params, pts_ind, cam_ind):
    """(K, 2) perspective projections of the observations' points."""
    return perspective_from_params(pts3d[pts_ind], cam_params[cam_ind])


def project(cam_model, pts3d, cam_params, pts_ind, cam_ind, rpcs=None):
    if cam_model == "rpc":
        return project_rpc(pts3d, rpcs, cam_params, pts_ind, cam_ind)
    if cam_model == "affine":
        return project_affine(pts3d, cam_params, pts_ind, cam_ind)
    if cam_model == "perspective":
        return project_perspective(pts3d, cam_params, pts_ind, cam_ind)
    raise ValueError(cam_model)


def residuals(cam_model, pts3d, cam_params, pts_ind, cam_ind, pts2d, weights, rpcs=None):
    """Weighted reprojection residuals w * (proj - obs), (K, 2)."""
    proj = project(cam_model, pts3d, cam_params, pts_ind, cam_ind, rpcs=rpcs)
    return weights[:, None] * (proj - pts2d)


def reprojection_error(cam_model, pts3d, cam_params, pts_ind, cam_ind, pts2d, rpcs=None):
    """Unweighted per-observation L2 reprojection error (K,)."""
    proj = project(cam_model, pts3d, cam_params, pts_ind, cam_ind, rpcs=rpcs)
    return torch.linalg.norm(proj - pts2d, dim=-1)
