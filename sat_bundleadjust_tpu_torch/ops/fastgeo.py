"""Transcendental-free ECEF -> normalized-RPC-coordinate evaluation.

Counterpart of `sat_bundleadjust_tpu/ops/fastgeo.py`. The residual needs
geodetic angles only as small differences from per-camera anchors (the RPC
offsets), so every transcendental of the Bowring chain is replaced by
algebraic sin/cos ratios and a small-angle atan series around the anchor
(< 1e-12 rad inside RPC validity scales). Same model as
`models/ellipsoid.ecef_to_latlon`.
"""

import math

import numpy as np
import torch

_A = 6378137.0
_E = 8.1819190842622e-2
_ESQ = _E * _E
_B = math.sqrt(_A * _A * (1.0 - _ESQ))
_EP2 = (_A * _A - _B * _B) / (_B * _B)
_DEG_PER_RAD = 180.0 / math.pi

ANCHOR_KEYS = ("sin_lat0", "cos_lat0", "sin_lon0", "cos_lon0")


def _atan_small(u):
    """atan(u) for |u| <= ~0.1: odd Taylor series to u^7."""
    u2 = u * u
    return u * (1.0 - u2 * (1.0 / 3.0 - u2 * (1.0 / 5.0 - u2 * (1.0 / 7.0))))


def anchors_from_rpcs(rpcs):
    """Per-camera anchor trig (sin/cos of lat_offset and lon_offset), as a
    dict of float64 tensors on the device of the rpc fields."""
    lat0 = torch.as_tensor(rpcs.lat_offset, dtype=torch.float64)
    lon0 = torch.as_tensor(rpcs.lon_offset, dtype=torch.float64)
    # host-side trig in numpy, so both packages get the same bits
    lat_np = lat0.cpu().numpy() / _DEG_PER_RAD
    lon_np = lon0.cpu().numpy() / _DEG_PER_RAD
    vals = (np.sin(lat_np), np.cos(lat_np), np.sin(lon_np), np.cos(lon_np))
    return {k: torch.as_tensor(v, device=lat0.device) for k, v in zip(ANCHOR_KEYS, vals)}


def normalized_geodetic(Y, rpc_k, anchors_k):
    """ECEF points Y (K, 3) -> (nlat, nlon, nalt, sin_lat, cos_lat) with
    per-observation RPCs rpc_k and anchors anchors_k."""
    x, y, z = Y[..., 0], Y[..., 1], Y[..., 2]
    p = torch.sqrt(x * x + y * y)

    # intermediate angle th = atan2(a z, b p): only its sin/cos are needed
    ta = _A * z
    tb = _B * p
    th_h = torch.sqrt(ta * ta + tb * tb)
    sin_th = ta / th_h
    cos_th = tb / th_h

    zz = z + _EP2 * _B * sin_th ** 3
    pp = p - _ESQ * _A * cos_th ** 3
    lat_h = torch.sqrt(zz * zz + pp * pp)
    sin_lat = zz / lat_h
    cos_lat = pp / lat_h

    n = _A / torch.sqrt(1.0 - _ESQ * sin_lat * sin_lat)
    alt = p / cos_lat - n

    s0, c0 = anchors_k["sin_lat0"], anchors_k["cos_lat0"]
    dlat_rad = _atan_small((zz * c0 - pp * s0) / (pp * c0 + zz * s0))
    sl0, cl0 = anchors_k["sin_lon0"], anchors_k["cos_lon0"]
    dlon_rad = _atan_small((y * cl0 - x * sl0) / (x * cl0 + y * sl0))

    # the anchors are the rpc offsets, so the angle offsets cancel exactly
    nlat = dlat_rad * (_DEG_PER_RAD / rpc_k.lat_scale)
    nlon = dlon_rad * (_DEG_PER_RAD / rpc_k.lon_scale)
    nalt = (alt - rpc_k.alt_offset) / rpc_k.alt_scale
    return nlat, nlon, nalt, sin_lat, cos_lat
