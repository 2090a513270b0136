"""Rational Polynomial Camera (RPC) model as a container of tensors.

Counterpart of `sat_bundleadjust_tpu/models/rpc.py:48-450`: the model,
batching, the RPC00B monomial basis and its derivatives, projection, and
localization by a fixed-count Newton iteration on the forward rational
model, and the file formats (IKONOS `KEY: value` text, json, GDAL geotiff
tags). `RPCModel` is a NamedTuple whose methods are the JAX model's
host-side conveniences (numpy projection and localization, copies, files);
device code calls the functions of this module.

Monomial order (RPC00B, x = normalized lat, y = normalized lon,
z = normalized alt):

    1, y, x, z, yx, yz, xz, y^2, x^2, z^2,
    xyz, y^3, yx^2, yz^2, y^2x, x^3, xz^2, y^2z, x^2z, z^3

`col` is governed by (samp_num, samp_den), `row` by (line_num, line_den).
"""

import json
import os
from typing import NamedTuple

import numpy as np
import torch

N_COEFFS = 20
NEWTON_ITERS = 15  # fixed Newton iteration count for localization


class RPCModel(NamedTuple):
    """RPC camera model. Fields are tensors (or numpy arrays / floats for a
    host-side description); leading dims broadcast."""

    line_num: torch.Tensor  # (..., 20) row numerator
    line_den: torch.Tensor  # (..., 20)
    samp_num: torch.Tensor  # (..., 20) col numerator
    samp_den: torch.Tensor  # (..., 20)
    row_offset: torch.Tensor  # (...,)
    col_offset: torch.Tensor
    lat_offset: torch.Tensor
    lon_offset: torch.Tensor
    alt_offset: torch.Tensor
    row_scale: torch.Tensor
    col_scale: torch.Tensor
    lat_scale: torch.Tensor
    lon_scale: torch.Tensor
    alt_scale: torch.Tensor

    def projection(self, lon, lat, alt):
        """Ground (lon, lat, alt) -> image (col, row), batched, evaluated on
        the host in numpy (rpc_projection_np); device code calls
        rpc_projection."""
        return rpc_projection_np(rpc_to_numpy(self), _host(lon), _host(lat), _host(alt))

    def localization(self, col, row, alt):
        """Image (col, row) at altitude alt -> ground (lon, lat), batched, on
        the host in numpy (rpc_localization_np); device code calls
        rpc_localization."""
        return rpc_localization_np(rpc_to_numpy(self), _host(col), _host(row), _host(alt))

    def to_numpy(self):
        return rpc_to_numpy(self)

    def copy(self):
        """A copy that shares no storage: tensors cloned, the rest copied
        into numpy arrays."""
        return map_rpc(lambda f: f.clone() if isinstance(f, torch.Tensor) else np.array(f), self)

    def write_to_file(self, path):
        write_rpc_file(self, path)

    def to_geotiff_dict(self):
        return rpc_to_geotiff_dict(self)


def map_rpc(fn, rpc):
    """Apply fn to every field of an RPCModel."""
    return RPCModel(*[fn(f) for f in rpc])


def stack_rpcs(rpcs, device):
    """Stack a list of RPCModel (host fields) into one batched float64
    RPCModel on device (leading dim M): each field in one array operation
    over the models, then one tensor."""
    fields = zip(*[tuple(r) for r in rpcs])
    return RPCModel(*[torch.as_tensor(np.array(vals, np.float64)).to(device) for vals in fields])


def index_rpc(batched, idx):
    """Gather per-item models from a batched RPCModel."""
    return map_rpc(lambda f: f[idx], batched)


# ----------------------------------------------------------------------
# polynomial basis and derivatives
# ----------------------------------------------------------------------


def poly20_basis(x, y, z):
    """Monomial basis (..., 20); x = normalized lat, y = lon, z = alt."""
    one = torch.ones_like(x)
    return torch.stack(
        [
            one, y, x, z, y * x, y * z, x * z, y * y, x * x, z * z,
            x * y * z, y * y * y, y * x * x, y * z * z, y * y * x,
            x * x * x, x * z * z, y * y * z, x * x * z, z * z * z,
        ],
        dim=-1,
    )


def poly20_basis_dx(x, y, z):
    """d(basis)/dx (x = normalized lat)."""
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    return torch.stack(
        [
            zero, zero, one, zero, y, zero, z, zero, 2 * x, zero,
            y * z, zero, 2 * x * y, zero, y * y, 3 * x * x, z * z, zero,
            2 * x * z, zero,
        ],
        dim=-1,
    )


def poly20_basis_dy(x, y, z):
    """d(basis)/dy (y = normalized lon)."""
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    return torch.stack(
        [
            zero, one, zero, zero, x, z, zero, 2 * y, zero, zero,
            x * z, 3 * y * y, x * x, z * z, 2 * y * x, zero, zero,
            2 * y * z, zero, zero,
        ],
        dim=-1,
    )


def poly20_basis_dz(x, y, z):
    """d(basis)/dz (z = normalized alt)."""
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    return torch.stack(
        [
            zero, zero, zero, one, zero, y, x, zero, zero, 2 * z,
            x * y, zero, zero, 2 * y * z, zero, zero, 2 * x * z, y * y,
            x * x, 3 * z * z,
        ],
        dim=-1,
    )


def apply_poly(coeffs, x, y, z):
    """Evaluate a 20-term polynomial: coeffs (..., 20) at points (...,)."""
    return torch.sum(poly20_basis(x, y, z) * coeffs, dim=-1)


def apply_rfm(num, den, x, y, z):
    return apply_poly(num, x, y, z) / apply_poly(den, x, y, z)


# ----------------------------------------------------------------------
# projection / localization
# ----------------------------------------------------------------------


def rpc_projection(rpc, lon, lat, alt):
    """Ground (lon, lat, alt) -> image (col, row). Batched."""
    nlon = (lon - rpc.lon_offset) / rpc.lon_scale
    nlat = (lat - rpc.lat_offset) / rpc.lat_scale
    nalt = (alt - rpc.alt_offset) / rpc.alt_scale
    col = apply_rfm(rpc.samp_num, rpc.samp_den, nlat, nlon, nalt)
    row = apply_rfm(rpc.line_num, rpc.line_den, nlat, nlon, nalt)
    return col * rpc.col_scale + rpc.col_offset, row * rpc.row_scale + rpc.row_offset


def _normalized_forward(rpc, nlon, nlat, nalt):
    """Normalized (lon, lat, alt) -> normalized (col, row) and the 2x2
    Jacobian d(col,row)/d(lon,lat), by the quotient rule."""
    b = poly20_basis(nlat, nlon, nalt)
    b_dlat = poly20_basis_dx(nlat, nlon, nalt)
    b_dlon = poly20_basis_dy(nlat, nlon, nalt)

    def rational(num, den):
        p = torch.sum(b * num, dim=-1)
        q = torch.sum(b * den, dim=-1)
        p_dlat = torch.sum(b_dlat * num, dim=-1)
        q_dlat = torch.sum(b_dlat * den, dim=-1)
        p_dlon = torch.sum(b_dlon * num, dim=-1)
        q_dlon = torch.sum(b_dlon * den, dim=-1)
        v = p / q
        return v, (p_dlon - v * q_dlon) / q, (p_dlat - v * q_dlat) / q

    col, col_dlon, col_dlat = rational(rpc.samp_num, rpc.samp_den)
    row, row_dlon, row_dlat = rational(rpc.line_num, rpc.line_den)
    return col, row, col_dlon, col_dlat, row_dlon, row_dlat


def rpc_localization(rpc, col, row, alt, n_iters=NEWTON_ITERS):
    """Image (col, row) at altitude alt -> ground (lon, lat), by a fixed
    number of Newton steps on the forward model with its exact 2x2
    Jacobian, starting from the normalized origin."""
    tcol = (col - rpc.col_offset) / rpc.col_scale
    trow = (row - rpc.row_offset) / rpc.row_scale
    nalt = (alt - rpc.alt_offset) / rpc.alt_scale
    nlon = torch.zeros_like(tcol)
    nlat = torch.zeros_like(trow)
    for _ in range(n_iters):
        c, r, c_dlon, c_dlat, r_dlon, r_dlat = _normalized_forward(rpc, nlon, nlat, nalt)
        fx = c - tcol
        fy = r - trow
        det = c_dlon * r_dlat - c_dlat * r_dlon
        # guard singular Jacobians on padded or degenerate inputs
        safe = torch.where(det.abs() < 1e-30, torch.ones_like(det), det)
        dlon = (r_dlat * fx - c_dlat * fy) / safe
        dlat = (-r_dlon * fx + c_dlon * fy) / safe
        nlon, nlat = nlon - dlon, nlat - dlat
    return nlon * rpc.lon_scale + rpc.lon_offset, nlat * rpc.lat_scale + rpc.lat_offset


# ----------------------------------------------------------------------
# numpy twins (host-side evaluation), sat_bundleadjust_tpu/models/rpc.py:322-416
# ----------------------------------------------------------------------


def _np_basis(x, y, z):
    """RPC00B monomial basis in numpy; x = lat_n, y = lon_n, z = alt_n."""
    one = np.ones_like(x)
    return np.stack(
        [
            one, y, x, z, y * x, y * z, x * z, y * y, x * x, z * z,
            x * y * z, y ** 3, y * x * x, y * z * z, y * y * x,
            x ** 3, x * z * z, y * y * z, x * x * z, z ** 3,
        ],
        axis=-1,
    )


def rpc_projection_np(rpc, lon, lat, alt):
    """Numpy twin of rpc_projection (float64, no device)."""
    r = rpc
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    alt = np.asarray(alt, dtype=np.float64)
    nlon = (lon - np.asarray(r.lon_offset)) / np.asarray(r.lon_scale)
    nlat = (lat - np.asarray(r.lat_offset)) / np.asarray(r.lat_scale)
    nalt = (alt - np.asarray(r.alt_offset)) / np.asarray(r.alt_scale)
    b = _np_basis(nlat, nlon, nalt)
    col = np.sum(b * np.asarray(r.samp_num), axis=-1) / np.sum(b * np.asarray(r.samp_den), axis=-1)
    row = np.sum(b * np.asarray(r.line_num), axis=-1) / np.sum(b * np.asarray(r.line_den), axis=-1)
    return (
        col * np.asarray(r.col_scale) + np.asarray(r.col_offset),
        row * np.asarray(r.row_scale) + np.asarray(r.row_offset),
    )


def rpc_localization_np(rpc, col, row, alt, n_iters=NEWTON_ITERS):
    """Numpy twin of rpc_localization: the same Newton iteration on the
    forward model with the analytic 2x2 Jacobian."""
    r = rpc
    col = np.asarray(col, dtype=np.float64)
    row = np.asarray(row, dtype=np.float64)
    alt = np.asarray(alt, dtype=np.float64)
    tcol = (col - np.asarray(r.col_offset)) / np.asarray(r.col_scale)
    trow = (row - np.asarray(r.row_offset)) / np.asarray(r.row_scale)
    nalt = (alt - np.asarray(r.alt_offset)) / np.asarray(r.alt_scale)

    samp_num = np.asarray(r.samp_num)
    samp_den = np.asarray(r.samp_den)
    line_num = np.asarray(r.line_num)
    line_den = np.asarray(r.line_den)

    def basis_d(x, y, z, kind):
        zero = np.zeros_like(x)
        one = np.ones_like(x)
        if kind == "dlat":  # d/dx
            return np.stack(
                [zero, zero, one, zero, y, zero, z, zero, 2 * x, zero,
                 y * z, zero, 2 * x * y, zero, y * y, 3 * x * x, z * z, zero,
                 2 * x * z, zero], axis=-1)
        # d/dy (lon)
        return np.stack(
            [zero, one, zero, zero, x, z, zero, 2 * y, zero, zero,
             x * z, 3 * y * y, x * x, z * z, 2 * y * x, zero, zero,
             2 * y * z, zero, zero], axis=-1)

    nlon = np.zeros_like(tcol)
    nlat = np.zeros_like(trow)
    for _ in range(n_iters):
        b = _np_basis(nlat, nlon, nalt)
        b_dlat = basis_d(nlat, nlon, nalt, "dlat")
        b_dlon = basis_d(nlat, nlon, nalt, "dlon")

        def rational(num, den):
            p = np.sum(b * num, axis=-1)
            q = np.sum(b * den, axis=-1)
            v = p / q
            v_dlat = (np.sum(b_dlat * num, axis=-1) - v * np.sum(b_dlat * den, axis=-1)) / q
            v_dlon = (np.sum(b_dlon * num, axis=-1) - v * np.sum(b_dlon * den, axis=-1)) / q
            return v, v_dlon, v_dlat

        c, c_dlon, c_dlat = rational(samp_num, samp_den)
        rr, r_dlon, r_dlat = rational(line_num, line_den)
        fx = c - tcol
        fy = rr - trow
        det = c_dlon * r_dlat - c_dlat * r_dlon
        det = np.where(np.abs(det) < 1e-30, 1.0, det)
        nlon = nlon - (r_dlat * fx - c_dlat * fy) / det
        nlat = nlat - (-r_dlon * fx + c_dlon * fy) / det

    return (
        nlon * np.asarray(r.lon_scale) + np.asarray(r.lon_offset),
        nlat * np.asarray(r.lat_scale) + np.asarray(r.lat_offset),
    )


def rpc_from_dict(d):
    """An RPCModel with numpy fields from a dict of floats/lists (keys =
    field names)."""
    def arr20(v):
        a = np.asarray(v, dtype=np.float64)
        if a.shape[-1] != N_COEFFS:
            raise ValueError("RPC coefficient vector of shape {}".format(a.shape))
        return a

    return RPCModel(
        line_num=arr20(d["line_num"]), line_den=arr20(d["line_den"]),
        samp_num=arr20(d["samp_num"]), samp_den=arr20(d["samp_den"]),
        **{k: np.float64(d[k]) for k in RPCModel._fields[4:]},
    )


# ----------------------------------------------------------------------
# construction and file IO (host-side, numpy),
# sat_bundleadjust_tpu/models/rpc.py:429-632
# ----------------------------------------------------------------------

_IKONOS_SCALAR_KEYS = {
    "LINE_OFF": "row_offset",
    "SAMP_OFF": "col_offset",
    "LAT_OFF": "lat_offset",
    "LONG_OFF": "lon_offset",
    "HEIGHT_OFF": "alt_offset",
    "LINE_SCALE": "row_scale",
    "SAMP_SCALE": "col_scale",
    "LAT_SCALE": "lat_scale",
    "LONG_SCALE": "lon_scale",
    "HEIGHT_SCALE": "alt_scale",
}

_COEFF_PREFIXES = {
    "LINE_NUM_COEFF": "line_num",
    "LINE_DEN_COEFF": "line_den",
    "SAMP_NUM_COEFF": "samp_num",
    "SAMP_DEN_COEFF": "samp_den",
}


def _host(v):
    """A field as a numpy array (tensors on any device are copied back)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def rpc_to_numpy(rpc):
    """An RPCModel with numpy fields."""
    return map_rpc(_host, rpc)


def rpc_to_dict(rpc):
    r = rpc_to_numpy(rpc)
    d = {k: getattr(r, k).tolist() for k in RPCModel._fields[:4]}
    d.update({k: float(getattr(r, k)) for k in RPCModel._fields[4:]})
    return d


def rpc_from_rpc_file(path):
    """Parse the IKONOS-style text format (`KEY: value [unit]` lines)."""
    scalars = {}
    coeffs = {v: np.zeros(N_COEFFS) for v in _COEFF_PREFIXES.values()}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            key, _, rest = line.partition(":")
            key = key.strip()
            value = rest.strip().split()[0]
            for prefix, field in _COEFF_PREFIXES.items():
                if key.startswith(prefix):
                    coeffs[field][int(key[len(prefix):].lstrip("_")) - 1] = float(value)
                    break
            else:
                if key in _IKONOS_SCALAR_KEYS:
                    scalars[_IKONOS_SCALAR_KEYS[key]] = float(value)
    d = dict(scalars)
    d.update(coeffs)
    return rpc_from_dict(d)


def write_rpc_file(rpc, path):
    """Write the IKONOS-style text format, every value with 12 decimals."""
    r = rpc_to_numpy(rpc)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    units = ["pixels", "pixels", "degrees", "degrees", "meters"] * 2
    lines = ["{}: {:.12f} {}".format(key, float(getattr(r, field)), unit)
             for (key, field), unit in zip(_IKONOS_SCALAR_KEYS.items(), units)]
    for prefix, field in _COEFF_PREFIXES.items():
        vals = getattr(r, field)
        for i in range(N_COEFFS):
            lines.append("{}_{}: {:.12f}".format(prefix, i + 1, float(vals[i])))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def rpc_from_json_file(path):
    """Our field names, or the rpcm json naming (row_num, col_den, ...)."""
    with open(path) as f:
        d = json.load(f)
    if "line_num" in d:
        return rpc_from_dict(d)
    remap = {"row_num": "line_num", "row_den": "line_den",
             "col_num": "samp_num", "col_den": "samp_den"}
    return rpc_from_dict({remap.get(k, k): v for k, v in d.items()})


def write_rpc_json(rpc, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rpc_to_dict(rpc), f, indent=2)


def rpc_from_geotiff_dict(tags):
    """An RPCModel from GDAL-style geotiff RPC tags (coefficient lists as
    space-separated strings or sequences)."""
    def coeflist(key):
        v = tags[key]
        return [float(x) for x in (v.split() if isinstance(v, str) else v)]

    d = {field: coeflist(key) for key, field in _COEFF_PREFIXES.items()}
    d.update({field: float(tags[key]) for key, field in _IKONOS_SCALAR_KEYS.items()})
    return rpc_from_dict(d)


def rpc_to_geotiff_dict(rpc):
    r = rpc_to_numpy(rpc)
    g = "{:.12g}".format
    out = {key: g(float(getattr(r, field))) for key, field in _IKONOS_SCALAR_KEYS.items()}
    out.update({key: " ".join(g(float(x)) for x in getattr(r, field))
                for key, field in _COEFF_PREFIXES.items()})
    return out


def scale_rpc(rpc, alpha):
    """The RPC of the image scaled by alpha (image offsets and scales)."""
    r = rpc_to_numpy(rpc)
    return r._replace(
        row_offset=r.row_offset * alpha,
        col_offset=r.col_offset * alpha,
        row_scale=r.row_scale * alpha,
        col_scale=r.col_scale * alpha,
    )
