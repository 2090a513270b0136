"""Camera model utilities: the SatelliteImage container, perspective matrix
decomposition, and the least-squares perspective fit of an RPC projection.

Counterpart of `sat_bundleadjust_tpu/models/cameras.py` (host-side numpy,
as there, apart from `apply_rpc_projection`, which runs on tensors). `affine_rpc_approx` (a Jacobian of the RPC chain) and the affine
matrix helpers wait for the matrix camera models.
"""

import numpy as np
import torch

from sat_bundleadjust_tpu_torch.models import ellipsoid
from sat_bundleadjust_tpu_torch.models.ellipsoid import latlon_to_ecef_np
from sat_bundleadjust_tpu_torch.models.rpc import rpc_localization_np, rpc_projection, rpc_projection_np


class SatelliteImage:
    """Input satellite image: a geotiff path, its RPC and its crop offset."""

    def __init__(self, geotiff_path, rpc, offset=None, size=None):
        self.geotiff_path = geotiff_path
        self.rpc = rpc
        if offset is None:
            if size is None:
                from sat_bundleadjust_tpu_torch.utils.io import read_image_size

                h, w = read_image_size(geotiff_path, rpc=rpc)
            else:
                h, w = size
            self.offset = {"col0": 0.0, "row0": 0.0, "width": w, "height": h}
        else:
            self.offset = offset
        self.center = None
        self.lonlat_geojson = None
        self.alt = None

    def set_camera_center(self, center=None):
        """Approximate satellite position from a perspective RPC fit."""
        if center is None:
            P, _ = perspective_rpc_approx(self.rpc, self.offset)
            _, _, _, self.center = decompose_perspective_camera(P)
        else:
            self.center = np.asarray(center)

    def set_footprint(self, lonlat_geojson=None, alt=0.0):
        """Geographic footprint polygon at altitude alt."""
        if lonlat_geojson is None:
            from sat_bundleadjust_tpu_torch.utils.geo import lonlat_geojson_from_geotiff_crop

            self.lonlat_geojson = lonlat_geojson_from_geotiff_crop(self.rpc, self.offset, z=alt)
        else:
            self.lonlat_geojson = lonlat_geojson
        self.alt = alt


def decompose_perspective_camera(P):
    """P = K R [I | -C] via RQ decomposition; the diagonal sign fix is applied
    once, so that K @ [R | vecT] == P up to scale."""
    from scipy import linalg

    P = np.asarray(P, dtype=np.float64)
    M, T = P[:, :-1], P[:, -1]
    K, R = linalg.rq(M)
    signs = np.diag(np.sign(np.diag(K)))
    R = signs @ R
    K = K @ signs
    oC = -np.linalg.inv(M) @ T
    vecT = (R @ -oC[:, np.newaxis]).T[0]
    return K, R, vecT, oC


def apply_rpc_projection(rpc, pts3d):
    """Project (..., 3) ECEF points with an RPC whose fields are tensors on
    the points' device: ECEF -> geodetic -> RPC, (..., 2) (col, row)."""
    lat, lon, alt = ellipsoid.ecef_to_latlon(pts3d[..., 0], pts3d[..., 1], pts3d[..., 2])
    col, row = rpc_projection(rpc, lon, lat, alt)
    return torch.stack((col, row), dim=-1)


def apply_rpc_projection_np(rpc, pts3d):
    """Host-side numpy twin of apply_rpc_projection."""
    pts3d = np.asarray(pts3d)
    lat, lon, alt = ellipsoid.ecef_to_latlon_np(pts3d[..., 0], pts3d[..., 1], pts3d[..., 2])
    col, row = rpc_projection_np(rpc, lon, lat, alt)
    return np.stack((col, row), axis=-1)


def generate_point_mesh(col_range, row_range, alt_range):
    """3-D grid of (col, row, alt) samples."""
    cols, rows, alts = [np.linspace(v[0], v[1], v[2]) for v in (col_range, row_range, alt_range)]
    a, r, c = np.meshgrid(alts, rows, cols, indexing="ij")
    return c.reshape(-1), r.reshape(-1), a.reshape(-1)


def approx_rpc_as_proj_matrix(rpc, col_range, lin_range, alt_range):
    """Least-squares perspective fit of an RPC over a 3-D sample grid."""
    cols, lins, alts = generate_point_mesh(col_range, lin_range, alt_range)
    lons, lats = rpc_localization_np(rpc, cols, lins, alts)
    x, y, z = latlon_to_ecef_np(lats, lons, alts)
    world_points = np.vstack([x, y, z]).T
    image_points = np.vstack([cols, lins]).T
    P = camera_matrix(world_points, image_points)
    proj = P @ np.hstack((world_points, np.ones((world_points.shape[0], 1)))).T
    image_points_proj = (proj[:2, :] / proj[-1, :]).T
    mean_err = np.mean(np.linalg.norm(image_points - image_points_proj, axis=1))
    return P, mean_err


def perspective_rpc_approx(rpc, offset):
    """Perspective approximation over the full crop."""
    x, y, w, h = offset["col0"], offset["row0"], offset["width"], offset["height"]
    alt = float(np.asarray(rpc.alt_offset))
    P_img, mean_err = approx_rpc_as_proj_matrix(
        rpc, [x, x + w, 10], [y, y + h, 10], [alt - 100, alt + 100, 10]
    )
    offset_translation = np.array([[1.0, 0.0, -x], [0.0, 1.0, -y], [0.0, 0.0, 1.0]])
    P = offset_translation @ P_img
    return P / P[2, 3], mean_err


def normalize_2d_points(pts):
    """Hartley normalization of 2-D points."""
    pts = np.asarray(pts, dtype=np.float64)
    c = pts.mean(axis=0)
    centered = pts - c
    mean_dist = np.mean(np.linalg.norm(centered, axis=1))
    s = np.sqrt(2) / mean_dist
    T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
    return centered * s, T


def normalize_3d_points(pts):
    """Hartley normalization of 3-D points."""
    pts = np.asarray(pts, dtype=np.float64)
    c = pts.mean(axis=0)
    centered = pts - c
    mean_dist = np.mean(np.linalg.norm(centered, axis=1))
    s = np.sqrt(3) / mean_dist
    U = np.eye(4)
    U[0, 0] = U[1, 1] = U[2, 2] = s
    U[:3, 3] = -s * c
    return centered * s, U


def camera_matrix(X, x):
    """DLT estimate of a 3x4 projection matrix from Nx3 <-> Nx2
    correspondences."""
    Xn, U = normalize_3d_points(X)
    xn, T = normalize_2d_points(x)
    n = Xn.shape[0]
    Xh = np.hstack([Xn, np.ones((n, 1))])
    A = np.zeros((2 * n, 12))
    A[0::2, 4:8] = -Xh
    A[0::2, 8:12] = xn[:, 1:2] * Xh
    A[1::2, 0:4] = Xh
    A[1::2, 8:12] = -xn[:, 0:1] * Xh
    _, _, V = np.linalg.svd(A)
    P = V[-1, :].reshape(3, 4)
    return np.linalg.inv(T) @ P @ U
