"""Camera model utilities: the SatelliteImage container, perspective and
affine projection matrices (composition, decomposition, projection), and
the local matrix approximations of an RPC projection (a first-order Taylor
expansion, a least-squares perspective fit).

Counterpart of `sat_bundleadjust_tpu/models/cameras.py` (host-side numpy,
as there, apart from `apply_rpc_projection`, which runs on tensors, and the
Jacobian of `affine_rpc_approx`, taken by torch.func on float64 CPU
tensors).
"""

import numpy as np
import torch

from sat_bundleadjust_tpu_torch.models import ellipsoid
from sat_bundleadjust_tpu_torch.models.ellipsoid import latlon_to_ecef_np
from sat_bundleadjust_tpu_torch.models.rpc import (
    map_rpc,
    rpc_localization_np,
    rpc_projection,
    rpc_projection_np,
)


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


def compose_perspective_camera(K, R, oC):
    """P = K R [I | -C]."""
    oC = np.asarray(oC).reshape(3)
    return np.asarray(K) @ np.asarray(R) @ np.hstack((np.eye(3), -oC.reshape(3, 1)))


def decompose_affine_camera(P):
    """Affine camera -> (K (2, 2), R (3, 3), vecT (2, 1)) (Hartley and
    Zisserman, 6.3.3)."""
    P = np.asarray(P, dtype=np.float64)
    M, T = P[:2, :3], np.array([P[:2, -1]])
    MMt = M @ M.T
    fy = np.sqrt(MMt[1, 1])
    s = MMt[1, 0] / fy
    fx = np.sqrt(MMt[0, 0] - s ** 2)
    K = np.array([[fx, s], [0, fy]])
    R = np.linalg.inv(K) @ M
    r1 = R[0, :][np.newaxis].T
    r2 = R[1, :][np.newaxis].T
    r3 = np.cross(r1, r2, axis=0)
    R = np.vstack((r1.T, r2.T, r3.T))
    vecT = np.linalg.inv(K) @ T[-1, np.newaxis].T
    return K, R, vecT


def compose_affine_camera(K, R, vecT):
    """(K (2, 2), R (3, 3), vecT (2,)) -> the 3x4 affine camera."""
    K = np.asarray(K)
    R = np.asarray(R)
    vecT = np.asarray(vecT)
    extrinsics = np.vstack([np.hstack([R[:2], vecT.reshape(2, 1)]), np.array([[0, 0, 0, 1]])])
    intrinsics = np.hstack([np.vstack([K, np.array([[0, 0]])]), np.array([[0, 0, 1]]).T])
    return intrinsics @ extrinsics


def apply_projection_matrix(P, pts3d):
    """Project (N, 3) points with a 3x4 matrix -> (N, 2)."""
    pts3d = np.asarray(pts3d)
    proj = np.asarray(P) @ np.hstack((pts3d, np.ones((pts3d.shape[0], 1)))).T
    return (proj[:2, :] / proj[-1, :]).T


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


def affine_rpc_approx(rpc, x, y, z, offset=None):
    """First-order Taylor expansion of the RPC projection at the ECEF point
    (x, y, z), as a 3x4 affine camera of the crop `offset`. The Jacobian of
    ECEF -> geodetic -> RPC is taken by forward-mode AD (torch.func.jacfwd)
    on float64 CPU tensors."""
    if offset is None:
        offset = {"col0": 0.0, "row0": 0.0}
    rpc_t = map_rpc(lambda f: torch.as_tensor(np.asarray(f, np.float64)), rpc)

    def project(p):
        lat, lon, alt = ellipsoid.ecef_to_latlon(p[0], p[1], p[2])
        col, row = rpc_projection(rpc_t, lon, lat, alt)
        return torch.stack([col, row])

    p0 = torch.tensor([float(x), float(y), float(z)], dtype=torch.float64)
    q = project(p0).numpy()
    J = torch.func.jacfwd(project)(p0).numpy()
    A = np.zeros((3, 4))
    A[:2, :3] = J
    A[:2, 3] = q - J @ p0.numpy()
    A[2, 3] = 1.0
    offset_translation = np.array(
        [[1.0, 0.0, -offset["col0"]], [0.0, 1.0, -offset["row0"]], [0.0, 0.0, 1.0]])
    P = offset_translation @ A
    return P / P[2, 3]


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
