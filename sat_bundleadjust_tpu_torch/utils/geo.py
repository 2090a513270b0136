"""Geographic coordinate systems and GeoJSON-style polygon helpers.

A copy of `sat_bundleadjust_tpu/utils/geo.py`.

Internalizes the roles of `pyproj`/`utm`/shapely used by the reference's
bundle_adjust/geo_utils.py (none of which exist in this environment). The
UTM transverse-Mercator conversion implements the standard Krueger series
(the same formulation as the public `utm` package), accurate to ~1e-3 m,
far below the tie-point accuracy it is used for (keypoint geo-consistency
filtering at ~meter scale, ft_match.py:220-247).
"""

import numpy as np

from sat_bundleadjust_tpu_torch.models.rpc import rpc_localization_np
from sat_bundleadjust_tpu_torch.utils.polygons import Polygon, convex_hull, union_polygon

# WGS84 / UTM constants
_K0 = 0.9996
_E = 0.00669438  # first eccentricity squared
_E2 = _E * _E
_E3 = _E2 * _E
_E_P2 = _E / (1.0 - _E)
_SQRT_E = np.sqrt(1.0 - _E)
__E = (1.0 - _SQRT_E) / (1.0 + _SQRT_E)
__E2 = __E * __E
__E3 = __E2 * __E
__E4 = __E3 * __E
__E5 = __E4 * __E
_M1 = 1.0 - _E / 4.0 - 3.0 * _E2 / 64.0 - 5.0 * _E3 / 256.0
_M2 = 3.0 * _E / 8.0 + 3.0 * _E2 / 32.0 + 45.0 * _E3 / 1024.0
_M3 = 15.0 * _E2 / 256.0 + 45.0 * _E3 / 1024.0
_M4 = 35.0 * _E3 / 3072.0
_P2 = 3.0 / 2.0 * __E - 27.0 / 32.0 * __E3 + 269.0 / 512.0 * __E5
_P3 = 21.0 / 16.0 * __E2 - 55.0 / 32.0 * __E4
_P4 = 151.0 / 96.0 * __E3 - 417.0 / 128.0 * __E5
_P5 = 1097.0 / 512.0 * __E4
_R = 6378137.0


def latlon_to_zone_number(lat, lon):
    """Standard UTM zone from the first point (special zones included)."""
    if 56 <= lat < 64 and 3 <= lon < 12:
        return 32
    if 72 <= lat <= 84 and lon >= 0:
        if lon < 9:
            return 31
        if lon < 21:
            return 33
        if lon < 33:
            return 35
        if lon < 42:
            return 37
    return int((lon + 180) / 6) + 1


def latitude_to_zone_letter(lat):
    letters = "CDEFGHJKLMNPQRSTUVWXX"
    if -80 <= lat <= 84:
        return letters[int(lat + 80) >> 3]
    return None


def utm_from_latlon(lats, lons, force_zone_number=None):
    """(lat, lon) arrays -> (east, north). Zone fixed by the first point
    (matches geo_utils.utm_from_latlon, geo_utils.py:22-30)."""
    lats = np.asarray(lats, dtype=np.float64)
    lons = np.asarray(lons, dtype=np.float64)
    scalar = lats.ndim == 0
    lats, lons = np.atleast_1d(lats), np.atleast_1d(lons)
    zone = force_zone_number or latlon_to_zone_number(float(lats.flat[0]), float(lons.flat[0]))

    lat_rad = np.radians(lats)
    lat_sin, lat_cos = np.sin(lat_rad), np.cos(lat_rad)
    lat_tan = lat_sin / lat_cos
    lat_tan2 = lat_tan * lat_tan
    lat_tan4 = lat_tan2 * lat_tan2
    lon_rad = np.radians(lons)
    central_lon_rad = np.radians((zone - 1) * 6 - 180 + 3)

    n = _R / np.sqrt(1.0 - _E * lat_sin ** 2)
    c = _E_P2 * lat_cos ** 2
    a = lat_cos * (lon_rad - central_lon_rad)
    a2, a3, a4, a5, a6 = a * a, a ** 3, a ** 4, a ** 5, a ** 6
    m = _R * (
        _M1 * lat_rad
        - _M2 * np.sin(2 * lat_rad)
        + _M3 * np.sin(4 * lat_rad)
        - _M4 * np.sin(6 * lat_rad)
    )
    easting = (
        _K0 * n * (a + a3 / 6 * (1 - lat_tan2 + c) + a5 / 120 * (5 - 18 * lat_tan2 + lat_tan4 + 72 * c - 58 * _E_P2))
        + 500000.0
    )
    northing = _K0 * (
        m
        + n
        * lat_tan
        * (a2 / 2 + a4 / 24 * (5 - lat_tan2 + 9 * c + 4 * c ** 2) + a6 / 720 * (61 - 58 * lat_tan2 + lat_tan4 + 600 * c - 330 * _E_P2))
    )
    # NOTE: like pyproj with "+proj=utm" (no +south), southern latitudes give
    # negative northings (no 10e6 offset); callers add it where needed,
    # mirroring the reference (geo_utils.py:72).
    if scalar:
        return float(easting[0]), float(northing[0])
    return easting, northing


def utm_from_lonlat(lons, lats, force_zone_number=None):
    """Reference: geo_utils.py:15-19."""
    return utm_from_latlon(lats, lons, force_zone_number)


def lonlat_from_utm(easts, norths, zone_number):
    """Inverse transverse-Mercator (Krueger series), zone given.

    Reference: geo_utils.py:57-63."""
    easts = np.atleast_1d(np.asarray(easts, dtype=np.float64))
    norths = np.atleast_1d(np.asarray(norths, dtype=np.float64))
    x = easts - 500000.0
    y = norths.copy()

    m = y / _K0
    mu = m / (_R * _M1)
    p_rad = (
        mu
        + _P2 * np.sin(2 * mu)
        + _P3 * np.sin(4 * mu)
        + _P4 * np.sin(6 * mu)
        + _P5 * np.sin(8 * mu)
    )
    p_sin = np.sin(p_rad)
    p_sin2 = p_sin * p_sin
    p_cos = np.cos(p_rad)
    p_tan = p_sin / p_cos
    p_tan2 = p_tan * p_tan
    p_tan4 = p_tan2 * p_tan2
    ep_sin = 1 - _E * p_sin2
    ep_sin_sqrt = np.sqrt(ep_sin)
    n = _R / ep_sin_sqrt
    r = (1 - _E) / ep_sin
    c = _E_P2 * p_cos ** 2
    c2 = c * c
    d = x / (n * _K0)
    d2, d3, d4, d5, d6 = d * d, d ** 3, d ** 4, d ** 5, d ** 6

    lat = p_rad - (p_tan / r) * (
        d2 / 2
        - d4 / 24 * (5 + 3 * p_tan2 + 10 * c - 4 * c2 - 9 * _E_P2)
        + d6 / 720 * (61 + 90 * p_tan2 + 298 * c + 45 * p_tan4 - 252 * _E_P2 - 3 * c2)
    )
    lon = (
        d
        - d3 / 6 * (1 + 2 * p_tan2 + c)
        + d5 / 120 * (5 - 2 * c + 28 * p_tan2 - 3 * c2 + 8 * _E_P2 + 24 * p_tan4)
    ) / p_cos
    central_lon = np.radians((int(zone_number) - 1) * 6 - 180 + 3)
    lons = np.degrees(lon + central_lon)
    lats = np.degrees(lat)
    return lons, lats


def zonestring_from_lonlat(lon, lat):
    """Zone number (the reference returns int(n) despite building a string,
    geo_utils.py:33-40)."""
    return latlon_to_zone_number(lat, lon)


def epsg_code_from_utm_zone(utm_zonestring):
    """Reference: geo_utils.py:43-54."""
    utm_zonestring = str(utm_zonestring)
    if utm_zonestring[-1].isalpha():
        zone_number = int(utm_zonestring[:-1])
        hemisphere = utm_zonestring[-1]
        const = 32600 if hemisphere >= "N" else 32700
    else:
        zone_number = int(utm_zonestring)
        const = 32600
    return const + zone_number


def utm_bbox_from_aoi_lonlat(lonlat_geojson):
    """Reference: geo_utils.py:66-74."""
    lons, lats = np.array(lonlat_geojson["coordinates"][0]).T
    easts, norths = utm_from_latlon(lats, lons)
    norths = np.array(norths)
    norths[norths < 0] += 10e6
    return {"xmin": easts.min(), "xmax": easts.max(), "ymin": norths.min(), "ymax": norths.max()}


def utm_bbox_shape(utm_bbx, resolution):
    """Reference: geo_utils.py:77-83."""
    height = int((utm_bbx["ymax"] - utm_bbx["ymin"]) // resolution + 1)
    width = int((utm_bbx["xmax"] - utm_bbx["xmin"]) // resolution + 1)
    return height, width


def compute_relative_utm_coords_inside_utm_bbx(pts2d_utm, utm_bbx, resolution):
    """Reference: geo_utils.py:86-97."""
    pts2d_utm = np.array(pts2d_utm, dtype=np.float64)
    easts, norths = pts2d_utm.T
    norths[norths < 0] += 10e6
    height, width = utm_bbox_shape(utm_bbx, resolution)
    cols = (easts - utm_bbx["xmin"]) // resolution
    rows = height - (norths - utm_bbx["ymin"]) // resolution
    return np.vstack([cols, rows]).T


# ----------------------------------------------------------------------
# GeoJSON-style polygons (dict with "coordinates", "type", "center")
# ----------------------------------------------------------------------


def geojson_polygon(coords_array):
    """Reference: geo_utils.py:117-139 (incl. the polar-angle reorder fix
    for unordered vertices)."""
    coords_array = np.asarray(coords_array, dtype=np.float64)
    poly = Polygon(coords_array)
    pp = coords_array.tolist()
    c = poly.centroid
    if not poly.is_valid:
        pp.sort(key=lambda p: np.arctan2(p[0] - c[0], p[1] - c[1]))
        c = Polygon(np.array(pp)).centroid
    out = {"coordinates": [pp], "type": "Polygon"}
    out["center"] = [float(c[0]), float(c[1])]
    return out


def geojson_to_polygon(geojson):
    """geojson dict -> Polygon (the shapely-replacement class)."""
    return Polygon(np.array(geojson["coordinates"][0]))


# alias with the reference's name for drop-in familiarity
geojson_to_shapely_polygon = geojson_to_polygon


def geojson_from_polygon(poly: Polygon):
    return geojson_polygon(poly.coords)


geojson_from_shapely_polygon = geojson_from_polygon


def geojson_polygon_convex_hull(coords_array):
    """Reference: geo_utils.py:159-166."""
    return geojson_from_polygon(Polygon(convex_hull(coords_array)))


def lonlat_geojson_from_geotiff_crop(rpc, crop_offset, z=0.0):
    """Footprint polygon of an image crop at altitude z
    (reference: geo_utils.py:100-114). Pure host-side numpy."""
    col0, row0 = crop_offset["col0"], crop_offset["row0"]
    w, h = crop_offset["width"], crop_offset["height"]
    cols = np.array([col0, col0, col0 + w, col0 + w, col0], dtype=np.float64)
    rows = np.array([row0, row0 + h, row0 + h, row0, row0], dtype=np.float64)
    alts = np.full(5, float(z))
    lons, lats = rpc_localization_np(rpc, cols, rows, alts)
    return geojson_polygon(np.vstack((np.asarray(lons), np.asarray(lats))).T)


def lonlat_geojson_from_utm_geojson(utm_geojson, utm_zone):
    easts, norths = np.array(utm_geojson["coordinates"][0]).T
    lons, lats = lonlat_from_utm(easts, norths, utm_zone)
    return geojson_polygon(np.vstack((lons, lats)).T)


def utm_geojson_from_lonlat_geojson(lonlat_geojson):
    lons, lats = np.array(lonlat_geojson["coordinates"][0]).T
    easts, norths = utm_from_lonlat(lons, lats)
    return geojson_polygon(np.vstack((easts, norths)).T)


def utm_zonestring_from_lonlat_geojson(lonlat_geojson):
    return zonestring_from_lonlat(*lonlat_geojson["center"])


def combine_utm_geojson_borders(utm_geojson_list):
    """Reference: geo_utils.py:196-205 (cascaded_union, convex-hull
    fallback). Here: convex hull of all vertices."""
    return geojson_from_polygon(union_polygon([geojson_to_polygon(g) for g in utm_geojson_list]))


def combine_lonlat_geojson_borders(lonlat_geojson_list):
    """Reference: geo_utils.py:208-215."""
    utm_zone = utm_zonestring_from_lonlat_geojson(lonlat_geojson_list[0])
    utm_list = [utm_geojson_from_lonlat_geojson(x) for x in lonlat_geojson_list]
    return lonlat_geojson_from_utm_geojson(combine_utm_geojson_borders(utm_list), utm_zone)


def measure_squared_km_from_lonlat_geojson(lonlat_geojson):
    """Reference: geo_utils.py:285-292."""
    utm_geojson = utm_geojson_from_lonlat_geojson(lonlat_geojson)
    return geojson_to_polygon(utm_geojson).area * 1e-6


def geoid_to_ellipsoid(lat, lon, z, geoid_pgm=None):
    """EGM96 geoid height -> WGS84 ellipsoid height.

    The undulation comes from a GeographicLib EGM96 .pgm grid
    (utils/geoid.py; pass geoid_pgm or set SATBA_GEOID_PGM), with pyproj
    and PROJ as the fallback where the grid is absent and pyproj is
    installed. Raises if neither source is available, rather than
    returning wrong heights."""
    import os

    from sat_bundleadjust_tpu_torch.utils.geoid import geoid_undulation

    if geoid_pgm or os.environ.get("SATBA_GEOID_PGM"):
        return np.asarray(z) + geoid_undulation(lat, lon, grid_path=geoid_pgm)
    try:
        import pyproj
    except ImportError as e:
        raise NotImplementedError(
            "geoid_to_ellipsoid needs an EGM96 source: set SATBA_GEOID_PGM "
            "to a GeographicLib egm96 .pgm grid, or install pyproj with "
            "PROJ data"
        ) from e
    ellipsoid = pyproj.CRS.from_epsg(4979)
    geoid = pyproj.CRS("EPSG:4326+5773")
    transformer = pyproj.Transformer.from_crs(geoid, ellipsoid)
    return transformer.transform(lat, lon, z)[-1]
