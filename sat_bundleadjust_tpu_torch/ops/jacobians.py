"""Analytic block Jacobians of the RPC reprojection residual.

Counterpart of `sat_bundleadjust_tpu/ops/jacobians.py`. Closed-form chain
rule for r = w * (proj(R(theta) (X - T - C) + C) - obs):

  dY/dtheta_k = (dR/dtheta_k) (X - T - C)
  dY/dX = R,  dY/dT = -R,  dY/dC = I - R
  d(geodetic)/dY = [d(ecef)/d(geodetic)]^-1   (inverse function theorem)
  d(col,row)/d(lat,lon,alt): quotient rule over the basis derivatives

The residual is evaluated in float64 (it cancels: proj - obs); the
Jacobian is assembled in `jac_dtype` (float32 by default).
"""

import math

import torch

from sat_bundleadjust_tpu_torch.models.rpc import (
    index_rpc,
    map_rpc,
    poly20_basis,
    poly20_basis_dx,
    poly20_basis_dy,
    poly20_basis_dz,
)
from sat_bundleadjust_tpu_torch.ops import smallmat as sm
from sat_bundleadjust_tpu_torch.ops.fastgeo import normalized_geodetic
from sat_bundleadjust_tpu_torch.ops.lm import _inv3x3

_A = 6378137.0
_E2 = 1.0 - (1.0 - 1.0 / 298.257223563) ** 2
_DEG = math.pi / 180.0


def _mat(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _rotation_and_derivs(euler):
    """R = Rz Ry Rx and dR/d(roll, pitch, yaw): euler (K, 3) -> R (K, 3, 3),
    dR (K, 3, 3, 3)."""
    a, b, c = euler[..., 0], euler[..., 1], euler[..., 2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    z = torch.zeros_like(a)
    o = torch.ones_like(a)

    Rx = _mat([[o, z, z], [z, ca, -sa], [z, sa, ca]])
    Ry = _mat([[cb, z, sb], [z, o, z], [-sb, z, cb]])
    Rz = _mat([[cc, -sc, z], [sc, cc, z], [z, z, o]])
    dRx = _mat([[z, z, z], [z, -sa, -ca], [z, ca, -sa]])
    dRy = _mat([[-sb, z, cb], [z, z, z], [-cb, z, -sb]])
    dRz = _mat([[-sc, -cc, z], [cc, -sc, z], [z, z, z]])

    RzRy = sm.mm(Rz, Ry)
    R = sm.mm(RzRy, Rx)
    dR = torch.stack(
        [sm.mm(RzRy, dRx), sm.mm(Rz, sm.mm(dRy, Rx)), sm.mm(dRz, sm.mm(Ry, Rx))],
        dim=-3,
    )
    return R, dR


def _decef_dgeodetic(sp, cp, sl, cl, alt):
    """d(x, y, z)/d(lat, lon, alt) with lat/lon in degrees, (K, 3, 3), from
    the algebraic sin/cos of lat (sp, cp) and lon (sl, cl)."""
    w = torch.sqrt(1.0 - _E2 * sp * sp)
    n = _A / w
    dn = _A * _E2 * sp * cp / (w ** 3)

    dx_dphi = (dn * cp - (n + alt) * sp) * cl
    dy_dphi = (dn * cp - (n + alt) * sp) * sl
    dz_dphi = dn * (1 - _E2) * sp + (n * (1 - _E2) + alt) * cp
    dx_dlam = -(n + alt) * cp * sl
    dy_dlam = (n + alt) * cp * cl
    dz_dlam = torch.zeros_like(sp)
    return _mat(
        [
            [dx_dphi * _DEG, dx_dlam * _DEG, cp * cl],
            [dy_dphi * _DEG, dy_dlam * _DEG, cp * sl],
            [dz_dphi * _DEG, dz_dlam * _DEG, sp],
        ]
    )


def _dproj_dgeo_jac(rpc_k, nlat, nlon, nalt):
    """d(col, row)/d(lat, lon, alt), (K, 2, 3), in the dtype of the inputs."""
    b = poly20_basis(nlat, nlon, nalt)
    b_dlat = poly20_basis_dx(nlat, nlon, nalt)
    b_dlon = poly20_basis_dy(nlat, nlon, nalt)
    b_dalt = poly20_basis_dz(nlat, nlon, nalt)

    def rational_derivs(num, den, scale):
        p = torch.sum(b * num, dim=-1)
        q = torch.sum(b * den, dim=-1)
        v = p / q

        def deriv(basis_d):
            pd = torch.sum(basis_d * num, dim=-1)
            qd = torch.sum(basis_d * den, dim=-1)
            return (pd - v * qd) / q * scale

        return deriv(b_dlat), deriv(b_dlon), deriv(b_dalt)

    c_dlat, c_dlon, c_dalt = rational_derivs(rpc_k.samp_num, rpc_k.samp_den, rpc_k.col_scale)
    r_dlat, r_dlon, r_dalt = rational_derivs(rpc_k.line_num, rpc_k.line_den, rpc_k.row_scale)
    return _mat(
        [
            [c_dlat / rpc_k.lat_scale, c_dlon / rpc_k.lon_scale, c_dalt / rpc_k.alt_scale],
            [r_dlat / rpc_k.lat_scale, r_dlon / rpc_k.lon_scale, r_dalt / rpc_k.alt_scale],
        ]
    )


def _project_normalized(rpc_k, nlat, nlon, nalt):
    b = poly20_basis(nlat, nlon, nalt)
    col = torch.sum(b * rpc_k.samp_num, dim=-1) / torch.sum(b * rpc_k.samp_den, dim=-1)
    row = torch.sum(b * rpc_k.line_num, dim=-1) / torch.sum(b * rpc_k.line_den, dim=-1)
    return torch.stack(
        [col * rpc_k.col_scale + rpc_k.col_offset, row * rpc_k.row_scale + rpc_k.row_offset],
        dim=-1,
    )


def residuals_rpc(pts3d, rpcs, cam_params, pts_ind, cam_ind, pts2d, weights, anchors):
    """Batched weighted residuals (K, 2) through the transcendental-free
    chain (the same arithmetic as residuals_and_jacobians_rpc's r)."""
    X = pts3d[pts_ind]
    P = cam_params[cam_ind]
    rpc_k = index_rpc(rpcs, cam_ind)
    anch_k = {k: v[cam_ind] for k, v in anchors.items()}
    theta, T, C = P[:, 0:3], P[:, 3:6], P[:, 6:9]
    R, _ = _rotation_and_derivs(theta)
    Y = sm.mv(R, X - T - C) + C
    nlat, nlon, nalt, _, _ = normalized_geodetic(Y, rpc_k, anch_k)
    return weights[:, None] * (_project_normalized(rpc_k, nlat, nlon, nalt) - pts2d)


def residuals_and_jacobians_rpc(pts3d, rpcs, cam_params, pts_ind, cam_ind, pts2d,
                                weights, n_params, anchors, jac_dtype=torch.float32):
    """Residuals and analytic Jacobian blocks for the rpc model.

    Returns r (K, 2) in the input precision, J_cam (K, 2, n_params) ordered
    [theta, T, C][:n_params] and J_pt (K, 2, 3), both in jac_dtype.
    `anchors` is fastgeo.anchors_from_rpcs(rpcs)."""
    X = pts3d[pts_ind]
    P = cam_params[cam_ind]
    rpc_k = index_rpc(rpcs, cam_ind)
    anch_k = {k: v[cam_ind] for k, v in anchors.items()}

    theta, T, C = P[:, 0:3], P[:, 3:6], P[:, 6:9]
    R, dR = _rotation_and_derivs(theta)
    Xc = X - T - C  # f64 difference of ~6.4e6 m coordinates
    Y = sm.mv(R, Xc) + C

    nlat, nlon, nalt, sin_lat, cos_lat = normalized_geodetic(Y, rpc_k, anch_k)
    r = weights[:, None] * (_project_normalized(rpc_k, nlat, nlon, nalt) - pts2d)

    def f(a):
        return a.to(jac_dtype)

    rpc_j = map_rpc(f, rpc_k)
    J_geo = _dproj_dgeo_jac(rpc_j, f(nlat), f(nlon), f(nalt))  # (K, 2, 3)

    p_xy = torch.sqrt(Y[:, 0] ** 2 + Y[:, 1] ** 2)
    sin_lon = f(Y[:, 1] / p_xy)
    cos_lon = f(Y[:, 0] / p_xy)
    alt = f(nalt * rpc_k.alt_scale + rpc_k.alt_offset)
    J_f = _decef_dgeodetic(f(sin_lat), f(cos_lat), sin_lon, cos_lon, alt)
    J_proj_Y = sm.mm(J_geo, _inv3x3(J_f))  # (K, 2, 3)

    Rj = f(R)
    wj = f(weights)[:, None, None]

    J_pt = sm.mm(J_proj_Y, Rj) * wj

    blocks = []
    if n_params > 0:  # theta
        dY_dtheta = torch.stack([f(sm.mv(dR[:, t], Xc)) for t in range(3)], dim=-1)
        blocks.append(sm.mm(J_proj_Y, dY_dtheta))
    if n_params > 3:  # T
        blocks.append(sm.mm(J_proj_Y, -Rj))
    if n_params > 6:  # C
        eye = torch.eye(3, dtype=jac_dtype, device=Rj.device)
        blocks.append(sm.mm(J_proj_Y, eye - Rj))
    if blocks:
        J_cam = torch.cat(blocks, dim=-1)[:, :, :n_params] * wj
    else:
        J_cam = torch.zeros(r.shape + (0,), dtype=jac_dtype, device=r.device)
    return r, J_cam, J_pt
