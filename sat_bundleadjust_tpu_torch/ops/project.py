"""Batched reprojection of tie points through corrected RPC cameras.

Counterpart of `sat_bundleadjust_tpu/ops/project.py` (rpc model). Camera
parameters per camera: [euler (3), T (3), C (3)]; the correction is
X' = R(X - T - C) + C, then the original RPC projects X'.
"""

import torch

from sat_bundleadjust_tpu_torch.models import ellipsoid
from sat_bundleadjust_tpu_torch.models.rotations import rotate_euler
from sat_bundleadjust_tpu_torch.models.rpc import index_rpc, rpc_projection


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


def residuals(pts3d, rpcs, cam_params, pts_ind, cam_ind, pts2d, weights):
    """Weighted reprojection residuals w * (proj - obs), (K, 2)."""
    proj = project_rpc(pts3d, rpcs, cam_params, pts_ind, cam_ind)
    return weights[:, None] * (proj - pts2d)
