"""Plain RPC geometry for the benchmark: no import of the program.

A frozen copy of the arithmetic that the benchmark's scenes and references
need: the RPC00B rational model (projection, and localization by a fixed
number of Newton steps on the forward model), the WGS84 conversions (the
single-pass Bowring inverse that defines the rpc camera model's projection
of ECEF points), the rotation of the rpc correction, and the IKONOS
`KEY: value` text files. Every function takes tensors of any float dtype
on any device, so that a reference can run it in float64 and its control
in float32.

Monomial order (x = normalized lat, y = normalized lon, z = normalized alt):
1, y, x, z, yx, yz, xz, y^2, x^2, z^2, xyz, y^3, yx^2, yz^2, y^2x, x^3,
xz^2, y^2z, x^2z, z^3.
"""

import math
import os

import numpy as np
import torch

FIELDS = ("line_num", "line_den", "samp_num", "samp_den", "row_offset", "col_offset",
          "lat_offset", "lon_offset", "alt_offset", "row_scale", "col_scale", "lat_scale",
          "lon_scale", "alt_scale")
NEWTON_ITERS = 15

A = 6378137.0
F = 1.0 / 298.257223563
E2 = 1.0 - (1.0 - F) * (1.0 - F)
E = 8.1819190842622e-2

SCALAR_KEYS = (("LINE_OFF", "row_offset", "pixels"), ("SAMP_OFF", "col_offset", "pixels"),
               ("LAT_OFF", "lat_offset", "degrees"), ("LONG_OFF", "lon_offset", "degrees"),
               ("HEIGHT_OFF", "alt_offset", "meters"), ("LINE_SCALE", "row_scale", "pixels"),
               ("SAMP_SCALE", "col_scale", "pixels"), ("LAT_SCALE", "lat_scale", "degrees"),
               ("LONG_SCALE", "lon_scale", "degrees"), ("HEIGHT_SCALE", "alt_scale", "meters"))
COEFF_KEYS = (("LINE_NUM_COEFF", "line_num"), ("LINE_DEN_COEFF", "line_den"),
              ("SAMP_NUM_COEFF", "samp_num"), ("SAMP_DEN_COEFF", "samp_den"))


def synthetic_rpc(lon0=-72.71, lat0=11.02, view_dx=0.0, view_dy=0.0,
                  img_halfsize=(1600.0, 675.0)):
    """A dict RPC, linear in normalized ground coordinates, with an altitude
    parallax of (view_dx, view_dy) px per normalized altitude."""
    colh, rowh = img_halfsize

    def poly(lin_l, lin_p, lin_h):
        p = np.zeros(20)
        p[1], p[2], p[3] = lin_l, lin_p, lin_h
        return p

    den = np.zeros(20)
    den[0] = 1.0
    return {"line_num": poly(0.08, 1.0, view_dy / rowh), "line_den": den.copy(),
            "samp_num": poly(1.0, -0.06, view_dx / colh), "samp_den": den.copy(),
            "row_offset": rowh, "col_offset": colh, "lat_offset": lat0, "lon_offset": lon0,
            "alt_offset": 50.0, "row_scale": rowh, "col_scale": colh, "lat_scale": 0.02,
            "lon_scale": 0.03, "alt_scale": 600.0}


def stack(rpcs, dtype=torch.float64, device="cpu"):
    """A list of dict RPCs -> one dict of tensors with a leading camera dim."""
    return {k: torch.as_tensor(np.array([np.asarray(r[k], np.float64) for r in rpcs]),
                               dtype=dtype, device=device) for k in FIELDS}


def index(batched, idx):
    return {k: v[idx] for k, v in batched.items()}


def _basis(x, y, z):
    one = torch.ones_like(x)
    return torch.stack([one, y, x, z, y * x, y * z, x * z, y * y, x * x, z * z,
                        x * y * z, y * y * y, y * x * x, y * z * z, y * y * x,
                        x * x * x, x * z * z, y * y * z, x * x * z, z * z * z], dim=-1)


def _basis_dx(x, y, z):
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return torch.stack([zero, zero, one, zero, y, zero, z, zero, 2 * x, zero,
                        y * z, zero, 2 * x * y, zero, y * y, 3 * x * x, z * z, zero,
                        2 * x * z, zero], dim=-1)


def _basis_dy(x, y, z):
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return torch.stack([zero, one, zero, zero, x, z, zero, 2 * y, zero, zero,
                        x * z, 3 * y * y, x * x, z * z, 2 * y * x, zero, zero,
                        2 * y * z, zero, zero], dim=-1)


def project(rpc, lon, lat, alt):
    """Ground (lon, lat, alt) -> image (col, row); rpc a dict of tensors
    broadcasting against the points."""
    nlon = (lon - rpc["lon_offset"]) / rpc["lon_scale"]
    nlat = (lat - rpc["lat_offset"]) / rpc["lat_scale"]
    nalt = (alt - rpc["alt_offset"]) / rpc["alt_scale"]
    b = _basis(nlat, nlon, nalt)
    col = (b * rpc["samp_num"]).sum(-1) / (b * rpc["samp_den"]).sum(-1)
    row = (b * rpc["line_num"]).sum(-1) / (b * rpc["line_den"]).sum(-1)
    return col * rpc["col_scale"] + rpc["col_offset"], row * rpc["row_scale"] + rpc["row_offset"]


def localize(rpc, col, row, alt, n_iters=NEWTON_ITERS):
    """Image (col, row) at altitude alt -> ground (lon, lat): Newton steps
    on the forward model from the normalized origin."""
    tcol = (col - rpc["col_offset"]) / rpc["col_scale"]
    trow = (row - rpc["row_offset"]) / rpc["row_scale"]
    nalt = (alt - rpc["alt_offset"]) / rpc["alt_scale"]
    nlon, nlat = torch.zeros_like(tcol), torch.zeros_like(trow)
    for _ in range(n_iters):
        b = _basis(nlat, nlon, nalt)
        bx, by = _basis_dx(nlat, nlon, nalt), _basis_dy(nlat, nlon, nalt)

        def rational(num, den):
            p, q = (b * num).sum(-1), (b * den).sum(-1)
            v = p / q
            return v, ((by * num).sum(-1) - v * (by * den).sum(-1)) / q, \
                ((bx * num).sum(-1) - v * (bx * den).sum(-1)) / q

        c, c_dlon, c_dlat = rational(rpc["samp_num"], rpc["samp_den"])
        r, r_dlon, r_dlat = rational(rpc["line_num"], rpc["line_den"])
        fx, fy = c - tcol, r - trow
        det = c_dlon * r_dlat - c_dlat * r_dlon
        det = torch.where(det.abs() < 1e-30, torch.ones_like(det), det)
        nlon = nlon - (r_dlat * fx - c_dlat * fy) / det
        nlat = nlat - (-r_dlon * fx + c_dlon * fy) / det
    return nlon * rpc["lon_scale"] + rpc["lon_offset"], nlat * rpc["lat_scale"] + rpc["lat_offset"]


def latlon_to_ecef(lat, lon, alt):
    """Geodetic (deg, deg, m) -> ECEF (..., 3) m."""
    rlat, rlon = lat * (math.pi / 180.0), lon * (math.pi / 180.0)
    s = torch.sin(rlat)
    v = A / torch.sqrt(1.0 - E2 * s * s)
    return torch.stack([(v + alt) * torch.cos(rlat) * torch.cos(rlon),
                        (v + alt) * torch.cos(rlat) * torch.sin(rlon),
                        (v * (1.0 - E2) + alt) * s], dim=-1)


def ecef_to_latlon(x, y, z):
    """ECEF (m) -> geodetic (deg, deg, m) by the single-pass Bowring
    approximation that the rpc camera model is defined with."""
    asq, esq = A ** 2, E ** 2
    b = math.sqrt(asq * (1.0 - esq))
    ep = math.sqrt((asq - b ** 2) / b ** 2)
    p = torch.sqrt(x ** 2 + y ** 2)
    th = torch.atan2(A * z, b * p)
    lon = torch.atan2(y, x)
    lat = torch.atan2(z + ep ** 2 * b * torch.sin(th) ** 3, p - esq * A * torch.cos(th) ** 3)
    n = A / torch.sqrt(1.0 - esq * torch.sin(lat) ** 2)
    return lat * (180.0 / math.pi), lon * (180.0 / math.pi), p / torch.cos(lat) - n


def rotate_euler(pts, angles):
    """Rotate (..., 3) points by (..., 3) Euler angles: Rx, then Ry, then Rz."""
    cx, sx = torch.cos(angles[..., 0]), torch.sin(angles[..., 0])
    cy, sy = torch.cos(angles[..., 1]), torch.sin(angles[..., 1])
    cz, sz = torch.cos(angles[..., 2]), torch.sin(angles[..., 2])
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    y, z = cx * y - sx * z, sx * y + cx * z
    x, z = cy * x + sy * z, -sy * x + cy * z
    x, y = cz * x - sz * y, sz * x + cz * y
    return torch.stack([x, y, z], dim=-1)


def project_corrected(rpc, pts, params):
    """(..., 2) pixels of ECEF points through rpc corrected by rows of
    [euler (3), T (3), C (3)]: X' = R(X - T - C) + C, then the RPC."""
    center = params[..., 6:9]
    adj = rotate_euler(pts - params[..., 3:6] - center, params[..., :3]) + center
    lat, lon, alt = ecef_to_latlon(adj[..., 0], adj[..., 1], adj[..., 2])
    return torch.stack(project(rpc, lon, lat, alt), dim=-1)


def write_file(rpc, path):
    """The IKONOS text format, every value with 12 decimals."""
    lines = ["{}: {:.12f} {}".format(key, float(rpc[field]), unit)
             for key, field, unit in SCALAR_KEYS]
    for key, field in COEFF_KEYS:
        lines += ["{}_{}: {:.12f}".format(key, i + 1, float(v)) for i, v in enumerate(rpc[field])]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_file(path):
    """A dict RPC (numpy float64) from the IKONOS text format."""
    scalars = {key: field for key, field, _ in SCALAR_KEYS}
    out = {field: np.zeros(20) for _, field in COEFF_KEYS}
    with open(path) as f:
        for line in f:
            key, sep, rest = line.partition(":")
            if not sep or not rest.split():
                continue
            key, value = key.strip(), float(rest.split()[0])
            for prefix, field in COEFF_KEYS:
                if key.startswith(prefix):
                    out[field][int(key[len(prefix):].lstrip("_")) - 1] = value
                    break
            else:
                if key in scalars:
                    out[scalars[key]] = value
    missing = [k for k in FIELDS if k not in out]
    if missing:
        raise ValueError("{}: no {}".format(os.path.basename(path), ", ".join(missing)))
    return out
