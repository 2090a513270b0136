"""WGS84 ellipsoid conversions on tensors.

Counterpart of `sat_bundleadjust_tpu/models/ellipsoid.py`. The inverse is
the single-pass Bowring approximation of the reference camera model (not an
iterative solve), kept formula for formula so that both packages project
identically.
"""

import math

import torch

_A = 6378137.0
_FINV = 298.257223563
_F = 1.0 / _FINV
_E2 = 1.0 - (1.0 - _F) * (1.0 - _F)
_E = 8.1819190842622e-2  # eccentricity of the reference inverse


def latlon_to_ecef(lat, lon, alt):
    """Geodetic (deg, deg, m) -> ECEF (m)."""
    rad_lat = lat * (math.pi / 180.0)
    rad_lon = lon * (math.pi / 180.0)
    sin_lat = torch.sin(rad_lat)
    v = _A / torch.sqrt(1.0 - _E2 * sin_lat * sin_lat)
    x = (v + alt) * torch.cos(rad_lat) * torch.cos(rad_lon)
    y = (v + alt) * torch.cos(rad_lat) * torch.sin(rad_lon)
    z = (v * (1.0 - _E2) + alt) * sin_lat
    return x, y, z


def latlon_to_ecef_arr(lat, lon, alt):
    """-> (..., 3) ECEF tensor."""
    return torch.stack(latlon_to_ecef(lat, lon, alt), dim=-1)


def ecef_to_latlon(x, y, z):
    """ECEF (m) -> geodetic (deg, deg, m), single-pass Bowring approximation."""
    asq = _A ** 2
    esq = _E ** 2
    b = math.sqrt(asq * (1.0 - esq))
    bsq = b ** 2
    ep = math.sqrt((asq - bsq) / bsq)
    p = torch.sqrt(x ** 2 + y ** 2)
    th = torch.atan2(_A * z, b * p)
    lon = torch.atan2(y, x)
    lat = torch.atan2(
        z + (ep ** 2) * b * (torch.sin(th) ** 3),
        p - esq * _A * (torch.cos(th) ** 3),
    )
    n = _A / torch.sqrt(1.0 - esq * (torch.sin(lat) ** 2))
    alt = p / torch.cos(lat) - n
    return lat * (180.0 / math.pi), lon * (180.0 / math.pi), alt


def ecef_to_latlon_arr(pts3d):
    """(..., 3) ECEF -> (lat, lon, alt) tuple."""
    return ecef_to_latlon(pts3d[..., 0], pts3d[..., 1], pts3d[..., 2])


def latlon_to_ecef_np(lat, lon, alt):
    """Numpy twin of latlon_to_ecef (host-side, float64)."""
    import numpy as np

    rad_lat = np.asarray(lat, dtype=np.float64) * (np.pi / 180.0)
    rad_lon = np.asarray(lon, dtype=np.float64) * (np.pi / 180.0)
    alt = np.asarray(alt, dtype=np.float64)
    sin_lat = np.sin(rad_lat)
    v = _A / np.sqrt(1.0 - _E2 * sin_lat * sin_lat)
    x = (v + alt) * np.cos(rad_lat) * np.cos(rad_lon)
    y = (v + alt) * np.cos(rad_lat) * np.sin(rad_lon)
    z = (v * (1.0 - _E2) + alt) * sin_lat
    return x, y, z


def ecef_to_latlon_np(x, y, z):
    """Numpy twin of ecef_to_latlon (host-side, float64)."""
    import numpy as np

    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    asq = _A ** 2
    esq = _E ** 2
    b = np.sqrt(asq * (1.0 - esq))
    ep = np.sqrt((asq - b ** 2) / (b ** 2))
    p = np.sqrt(x ** 2 + y ** 2)
    th = np.arctan2(_A * z, b * p)
    lon = np.arctan2(y, x)
    lat = np.arctan2(z + (ep ** 2) * b * (np.sin(th) ** 3), p - esq * _A * (np.cos(th) ** 3))
    n = _A / np.sqrt(1.0 - esq * (np.sin(lat) ** 2))
    alt = p / np.cos(lat) - n
    return lat * (180.0 / np.pi), lon * (180.0 / np.pi), alt
