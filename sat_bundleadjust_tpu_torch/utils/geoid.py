"""EGM96 geoid undulation from a GeographicLib geoid grid.

A copy of `sat_bundleadjust_tpu/utils/geoid.py` (host numpy). It reads
GeographicLib's .pgm geoid files (egm96-5.pgm / egm96-15.pgm,
https://geographiclib.sourceforge.io/html/geoid.html), so the conversion
works without pyproj/PROJ:

  * P5 (binary) PGM, 16-bit big-endian samples;
  * header comments carry "# Offset <o>" and "# Scale <s>";
    undulation N = o + s * pixel;
  * the grid covers lat 90..-90 (rows, north first) and lon 0..360
    (columns), cell-registered on the grid nodes.

The grid is data and is not in the repository: point SATBA_GEOID_PGM at a
copy, or pass grid_path.
"""

import os

import numpy as np

_CACHE = {}


def load_geoid_pgm(path):
    """Parse a GeographicLib geoid .pgm -> (grid (H, W) float64 meters,
    offset unused afterwards). Raises ValueError on malformed files."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P5"):
        raise ValueError("not a binary PGM: {}".format(path))
    # tokenize header: magic, width, height, maxval, with # comments
    offset = None
    scale = None
    pos = 2
    fields = []
    while len(fields) < 3:
        # skip whitespace
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            eol = data.index(b"\n", pos)
            comment = data[pos + 1 : eol].decode("ascii", "replace").strip()
            if comment.startswith("Offset"):
                offset = float(comment.split()[1])
            elif comment.startswith("Scale"):
                scale = float(comment.split()[1])
            pos = eol + 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    w, h, maxval = fields
    if maxval != 65535:
        raise ValueError("geoid pgm must be 16-bit (maxval 65535), got {}".format(maxval))
    if offset is None or scale is None:
        raise ValueError("geoid pgm lacks Offset/Scale header comments: {}".format(path))
    pos += 1  # single whitespace after maxval
    raw = np.frombuffer(data, dtype=">u2", count=w * h, offset=pos)
    return offset + scale * raw.reshape(h, w).astype(np.float64)


def _grid(path):
    if path not in _CACHE:
        _CACHE[path] = load_geoid_pgm(path)
    return _CACHE[path]


def geoid_undulation(lat, lon, grid_path=None):
    """EGM96 geoid height above the WGS84 ellipsoid at (lat, lon), via
    bilinear interpolation of a GeographicLib geoid grid."""
    if grid_path is None:
        grid_path = os.environ.get("SATBA_GEOID_PGM")
    if not grid_path or not os.path.exists(grid_path):
        raise FileNotFoundError(
            "EGM96 geoid grid not found; download egm96-5.pgm from "
            "GeographicLib and set SATBA_GEOID_PGM (or pass grid_path)"
        )
    g = _grid(grid_path)
    h, w = g.shape
    lat = np.atleast_1d(np.asarray(lat, float))
    lon = np.mod(np.atleast_1d(np.asarray(lon, float)), 360.0)
    # rows: lat 90 -> -90 over h nodes; cols: lon 0 -> 360 over w nodes
    # (the last column duplicates lon 0 at lon 360 in GeographicLib grids)
    r = (90.0 - lat) / 180.0 * (h - 1)
    c = lon / 360.0 * (w - 1)
    r0 = np.clip(np.floor(r).astype(int), 0, h - 2)
    c0 = np.clip(np.floor(c).astype(int), 0, w - 2)
    fr, fc = r - r0, c - c0
    return (
        g[r0, c0] * (1 - fr) * (1 - fc)
        + g[r0, c0 + 1] * (1 - fr) * fc
        + g[r0 + 1, c0] * fr * (1 - fc)
        + g[r0 + 1, c0 + 1] * fr * fc
    )
