"""Stereo-pair RPC geometry helpers.

Counterpart of `sat_bundleadjust_tpu/models/stereo.py`, the surface of the
reference's s2p compatibility layer: `rpc_utils` (corresponding points,
iterative height, bounding boxes, GCP grids, GSD) and `estimation`
(rectifying similarities, affine homographies). The RPC evaluations run
in float64 on `device` (default: the card) and return host numpy values,
except `find_corresponding_point`, which returns tensors; the estimation
helpers are host numpy, as there.
"""

import numpy as np
import torch

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.models import ellipsoid
from sat_bundleadjust_tpu_torch.models.cameras import generate_point_mesh
from sat_bundleadjust_tpu_torch.models.rpc import map_rpc, rpc_localization, rpc_projection


def _on(dev, *arrays):
    """Float64 tensors on dev."""
    return [torch.as_tensor(np.asarray(a, np.float64), device=dev) for a in arrays]


def _rpc_on(rpc, dev):
    return map_rpc(lambda f: torch.as_tensor(f, dtype=torch.float64, device=dev), rpc)


def altitude_range_coarse(rpc, scale_factor=1.0):
    """Coarse altitude validity range of an RPC."""
    m = float(np.asarray(rpc.alt_offset)) - scale_factor * float(np.asarray(rpc.alt_scale))
    M = float(np.asarray(rpc.alt_offset)) + scale_factor * float(np.asarray(rpc.alt_scale))
    return m, M


def geodesic_bounding_box(rpc, x, y, w, h, device=None):
    """Lon/lat extrema of an image ROI over the altitude range."""
    dev = resolve_device(device)
    m, M = altitude_range_coarse(rpc)
    cols, rows, alts = _on(dev, [x, x, x, x, x + w, x + w, x + w, x + w],
                           [y, y, y + h, y + h, y, y, y + h, y + h], [m, M, m, M, m, M, m, M])
    lons, lats = rpc_localization(_rpc_on(rpc, dev), cols, rows, alts)
    lons, lats = lons.cpu().numpy(), lats.cpu().numpy()
    return lons.min(), lons.max(), lats.min(), lats.max()


def find_corresponding_point(rpc_a, rpc_b, x, y, z, device=None):
    """Pixel (x, y) of image a at altitude z -> pixel (xp, yp) of image b
    (tensors on device), and z."""
    dev = resolve_device(device)
    x, y, zt = _on(dev, x, y, z)
    lon, lat = rpc_localization(_rpc_on(rpc_a, dev), x, y, zt)
    xp, yp = rpc_projection(_rpc_on(rpc_b, dev), lon, lat, zt)
    return xp, yp, z


def compute_height(rpc1, rpc2, x1, y1, x2, y2, device=None):
    """Altitude of matched pixel pairs by the batched triangulation
    (`ops/triangulate.rpc_triangulate`, the two models stacked as cameras 0
    and 1). Returns (height, error)."""
    from sat_bundleadjust_tpu_torch.ops.triangulate import rpc_triangulate

    dev = resolve_device(device)
    x1, y1, x2, y2 = _on(dev, *[np.atleast_1d(np.asarray(v, np.float64)) for v in (x1, y1, x2, y2)])
    rpcs = map_rpc(torch.stack, zip(_rpc_on(rpc1, dev), _rpc_on(rpc2, dev)))
    cam = torch.zeros(x1.numel(), dtype=torch.int64, device=dev)
    pts3d, err = rpc_triangulate(rpcs, cam, cam + 1, torch.stack([x1, y1], dim=-1).reshape(-1, 2),
                                 torch.stack([x2, y2], dim=-1).reshape(-1, 2))
    _, _, alt = ellipsoid.ecef_to_latlon_arr(pts3d)
    return alt.reshape(x1.shape).cpu().numpy(), err.reshape(x1.shape).cpu().numpy()


def ground_control_points(rpc, x, y, w, h, m, M, n, device=None):
    """n^3 GCP grid over an ROI and an altitude range: (lons, lats, alts)."""
    dev = resolve_device(device)
    col_range = [x + (1.0 / (2 * n)) * w, x + ((2 * n - 1.0) / (2 * n)) * w, n]
    row_range = [y + (1.0 / (2 * n)) * h, y + ((2 * n - 1.0) / (2 * n)) * h, n]
    cols, rows, alts = generate_point_mesh(col_range, row_range, [m, M, n])
    lons, lats = rpc_localization(_rpc_on(rpc, dev), *_on(dev, cols, rows, alts))
    return lons.cpu().numpy(), lats.cpu().numpy(), alts


def matches_from_rpc(rpc1, rpc2, x, y, w, h, n, device=None):
    """Virtual matches (x1, y1, x2, y2) between two RPC views, from the
    n^3 GCP grid of view 1's ROI."""
    dev = resolve_device(device)
    m, M = altitude_range_coarse(rpc1)
    lons, lats, alts = _on(dev, *ground_control_points(rpc1, x, y, w, h, m, M, n, device=dev))
    x1, y1 = rpc_projection(_rpc_on(rpc1, dev), lons, lats, alts)
    x2, y2 = rpc_projection(_rpc_on(rpc2, dev), lons, lats, alts)
    return torch.stack([x1, y1, x2, y2], dim=1).cpu().numpy()


def gsd_from_rpc(rpc, z=0.0, device=None):
    """Ground sampling distance in meters per pixel at the RPC centre."""
    dev = resolve_device(device)
    c = float(np.asarray(rpc.col_offset))
    r = float(np.asarray(rpc.row_offset))
    cols, rows, alts = _on(dev, [c, c + 1], [r, r], [z, z])
    lons, lats = rpc_localization(_rpc_on(rpc, dev), cols, rows, alts)
    pts = ellipsoid.latlon_to_ecef_arr(lats, lons, alts)
    return float(torch.linalg.norm(pts[0] - pts[1]))


# ----------------------------------------------------------------------
# estimation (host numpy)
# ----------------------------------------------------------------------


def fundamental_matrix_cameras(P1, P2):
    """F from two projection matrices."""
    P1 = np.asarray(P1)
    P2 = np.asarray(P2)
    X = (P1[[1, 2], :], P1[[2, 0], :], P1[[0, 1], :])
    Y = (P2[[1, 2], :], P2[[2, 0], :], P2[[0, 1], :])
    F = np.zeros((3, 3))
    for i, Yi in enumerate(Y):
        for j, Xj in enumerate(X):
            F[i, j] = np.linalg.det(np.vstack([Xj, Yi]))
    return F


def rectifying_similarities_from_affine_fundamental_matrix(F, debug=False):
    """Rectifying similarities S1, S2 from an affine F."""
    a = F[0, 2]
    b = F[1, 2]
    c = F[2, 0]
    d = F[2, 1]
    e = F[2, 2]

    r = np.hypot(c, d)
    s = np.hypot(a, b)
    R1 = (1.0 / r) * np.array([[d, -c], [c, d]])
    R2 = (1.0 / s) * np.array([[-b, a], [-a, -b]])
    z = np.sqrt(r / s)
    t = 0.5 * e / np.sqrt(r * s)

    S1 = np.zeros((3, 3))
    S1[0:2, 0:2] = z * R1
    S1[1, 2] = t
    S1[2, 2] = 1.0
    S2 = np.zeros((3, 3))
    S2[0:2, 0:2] = (1.0 / z) * R2
    S2[1, 2] = -t
    S2[2, 2] = 1.0
    return S1, S2


def affine_transformation(x, xx):
    """Least-squares affine homography x -> xx."""
    x = np.asarray(x)
    xx = np.asarray(xx)
    n = x.shape[0]
    A = np.zeros((2 * n, 6))
    b = np.zeros(2 * n)
    A[0::2, 0:2] = x
    A[0::2, 2] = 1.0
    A[1::2, 3:5] = x
    A[1::2, 5] = 1.0
    b[0::2] = xx[:, 0]
    b[1::2] = xx[:, 1]
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    T = np.eye(3)
    T[0, :] = sol[0:3]
    T[1, :] = sol[3:6]
    return T


def translation(x, xx):
    """Mean-translation homography."""
    t = np.mean(np.asarray(xx) - np.asarray(x), axis=0)
    T = np.eye(3)
    T[0, 2] = t[0]
    T[1, 2] = t[1]
    return T
