"""Terrain altitude sources for footprint computation.

Counterpart of `sat_bundleadjust_tpu/utils/dem.py` (host numpy, one sample
per image):
  * GeoTiffDEM: bilinear sampling of a user-supplied single-band DEM
    GeoTIFF, geographic (lon/lat) or projected UTM, through the GeoTIFF
    keys read by utils/tiffmeta;
  * srtm4_altitudes: the srtm4 package, where it is installed (it
    downloads its tiles);
  * make_alt_getter: the pipeline's hook, DEM path > srtm4 > None (the
    pipeline then takes the clamped RPC altitude offset,
    `pipeline.default_altitude`).
"""

import numpy as np

from sat_bundleadjust_tpu_torch.utils.tiffmeta import read_tiff_tags

T_PIXEL_SCALE, T_TIEPOINT, T_GEO_KEYS, T_NODATA = 33550, 33922, 34735, 42113


def _geokey(keys, key_id):
    """Value of a GeoKey stored inline in the GeoKeyDirectory, or None."""
    if not keys:
        return None
    for i in range(4, len(keys), 4):
        if keys[i] == key_id and keys[i + 1] == 0:
            return keys[i + 3]
    return None


class GeoTiffDEM:
    """Bilinear altitude sampling from a single-band DEM GeoTIFF."""

    def __init__(self, path):
        from PIL import Image

        self.path = path
        self.data = np.asarray(Image.open(path), dtype=np.float64)
        if self.data.ndim != 2:
            raise ValueError("DEM must be single-band: {}".format(path))
        tags = read_tiff_tags(path, wanted=(T_PIXEL_SCALE, T_TIEPOINT, T_GEO_KEYS, T_NODATA))
        if T_PIXEL_SCALE not in tags or T_TIEPOINT not in tags:
            raise ValueError("DEM lacks GeoTIFF georeferencing tags: {}".format(path))
        sx, sy = tags[T_PIXEL_SCALE][0], tags[T_PIXEL_SCALE][1]
        tp = tags[T_TIEPOINT]
        # raster (tp[0], tp[1]) maps to model (tp[3], tp[4]); rows go south
        self.x0 = tp[3] - tp[0] * sx
        self.y0 = tp[4] + tp[1] * sy
        self.sx, self.sy = float(sx), float(sy)
        keys = tags.get(T_GEO_KEYS)
        model = _geokey(keys, 1024)  # GTModelTypeGeoKey: 1 projected, 2 geographic
        self.epsg = _geokey(keys, 3072) if model == 1 else None
        nod = tags.get(T_NODATA)
        try:
            self.nodata = float(nod) if nod is not None else None
        except ValueError:
            self.nodata = float("nan")

    def _to_raster_xy(self, lons, lats):
        if self.epsg is not None:
            from sat_bundleadjust_tpu_torch.utils.geo import utm_from_lonlat

            zone = (int(self.epsg) % 100) if int(self.epsg) % 100 <= 60 else None
            x, y = utm_from_lonlat(np.asarray(lons), np.asarray(lats), force_zone_number=zone)
            if int(self.epsg) // 100 == 327:  # southern hemisphere: y offset
                y = np.where(np.asarray(y) < 0, np.asarray(y) + 10e6, np.asarray(y))
        else:
            x, y = np.asarray(lons, float), np.asarray(lats, float)
        cols = (np.asarray(x, float) - self.x0) / self.sx
        rows = (self.y0 - np.asarray(y, float)) / self.sy
        return cols, rows

    def altitudes(self, lons, lats):
        """Bilinear altitude at (lon, lat); NaN outside the raster or at
        nodata (the contract of srtm4.srtm4)."""
        lons = np.atleast_1d(np.asarray(lons, float))
        lats = np.atleast_1d(np.asarray(lats, float))
        cols, rows = self._to_raster_xy(lons, lats)
        h, w = self.data.shape
        out = np.full(cols.shape, np.nan)
        ok = (cols >= 0) & (rows >= 0) & (cols <= w - 1) & (rows <= h - 1)
        if not ok.any():
            return out
        c, r = cols[ok], rows[ok]
        c0 = np.clip(np.floor(c).astype(int), 0, w - 2)
        r0 = np.clip(np.floor(r).astype(int), 0, h - 2)
        fc, fr = c - c0, r - r0
        z00 = self.data[r0, c0]
        z01 = self.data[r0, c0 + 1]
        z10 = self.data[r0 + 1, c0]
        z11 = self.data[r0 + 1, c0 + 1]
        z = z00 * (1 - fr) * (1 - fc) + z01 * (1 - fr) * fc + z10 * fr * (1 - fc) + z11 * fr * fc
        if self.nodata is not None:
            bad = (_is_nodata(z00, self.nodata) | _is_nodata(z01, self.nodata)
                   | _is_nodata(z10, self.nodata) | _is_nodata(z11, self.nodata))
            z = np.where(bad, np.nan, z)
        out[ok] = z
        return out


def _is_nodata(v, nodata):
    if np.isnan(nodata):
        return np.isnan(v)
    return v == nodata


def srtm4_available():
    try:
        import srtm4  # noqa: F401
    except ImportError:
        return False
    return True


def srtm4_altitudes(lons, lats):
    """Altitudes from the srtm4 package (it downloads its tiles)."""
    import srtm4

    return np.atleast_1d(np.asarray(srtm4.srtm4(lons, lats), dtype=float))


def make_alt_getter(dem_path=None, use_srtm4=None):
    """The set_footprints(alt_getter=...) hook: an image -> altitude
    callable sampling at the RPC center (lon_offset, lat_offset), or None
    when no altitude source is configured. With a DEM, an image whose
    sample is NaN (out of the raster, nodata) gets the clamped RPC altitude
    offset."""
    if dem_path is not None:
        dem = GeoTiffDEM(dem_path)

        def getter(im):
            from sat_bundleadjust_tpu_torch.pipeline import default_altitude

            lon = float(np.asarray(im.rpc.lon_offset))
            lat = float(np.asarray(im.rpc.lat_offset))
            z = float(dem.altitudes(lon, lat)[0])
            return z if np.isfinite(z) else default_altitude(im.rpc)

        return getter
    if use_srtm4 or (use_srtm4 is None and srtm4_available()):

        def getter(im):
            lon = float(np.asarray(im.rpc.lon_offset))
            lat = float(np.asarray(im.rpc.lat_offset))
            return float(srtm4_altitudes(lon, lat)[0])

        return getter
    return None
