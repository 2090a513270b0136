"""Terrain altitude sources for footprint computation.

Counterpart of `sat_bundleadjust_tpu/utils/dem.py`, its no-DEM branch:
`make_alt_getter` returns None when neither a DEM path is given nor the
srtm4 package is installed, and the pipeline then takes the clamped RPC
altitude offset (`pipeline.default_altitude`). The DEM GeoTIFF sampler
(`GeoTiffDEM`) is not ported yet (ROADMAP.md, Queue 1 item 13): a
`dem_path` raises instead of being ignored.
"""

import numpy as np


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
    callable sampling at the RPC center, or None when no altitude source is
    configured."""
    if dem_path is not None:
        raise NotImplementedError(
            "dem_path={!r}: DEM altitudes (GeoTiffDEM) are not ported yet "
            "(ROADMAP.md, Queue 1 item 13); remove dem_path to use the RPC "
            "altitude offset".format(dem_path))
    if use_srtm4 or (use_srtm4 is None and srtm4_available()):

        def getter(im):
            lon = float(np.asarray(im.rpc.lon_offset))
            lat = float(np.asarray(im.rpc.lat_offset))
            return float(srtm4_altitudes(lon, lat)[0])

        return getter
    return None
