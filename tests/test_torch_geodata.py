"""Parity of the port's geodata modules with the JAX package's, on the CPU:
the DEM sampler (utils/dem.py: GeoTiffDEM, make_alt_getter), the geoid grid
(utils/geoid.py) and geo.geoid_to_ellipsoid.

All three are host numpy in both packages, the same code on the same files,
so the results must be equal bit for bit (NaN where JAX has NaN). The
DEMs are tilted planes written by the port's utils/tiffwrite, with
coefficients that make every node exact in float32, so that the bilinear
sample is also known from the plane's formula: within 1e-6 m (a bilinear
blend of a plane is the plane; what is left is float64 rounding).
"""

import struct

import numpy as np
import pytest

from sat_bundleadjust_tpu.utils import dem as jdem
from sat_bundleadjust_tpu.utils import geo as jgeo
from sat_bundleadjust_tpu.utils import geoid as jgeoid
from sat_bundleadjust_tpu.utils.demo import make_synthetic_rpc as jrpc

from sat_bundleadjust_tpu_torch.utils import dem as tdem
from sat_bundleadjust_tpu_torch.utils import geo as tgeo
from sat_bundleadjust_tpu_torch.utils import geoid as tgeoid
from sat_bundleadjust_tpu_torch.utils import tiffwrite
from sat_bundleadjust_tpu_torch.utils.demo import make_synthetic_rpc as trpc
from sat_bundleadjust_tpu_torch.pipeline import default_altitude


def _plane(a, b, c):
    """z = a + b * dx + c * dy, dx and dy in raster steps east and south of
    the raster's corner: with dyadic a, b, c every node is a float32."""
    return lambda dx, dy: a + b * dx + c * dy


def _utm_dem(path, lon0, lat0, plane, res=32.0, half=3008.0, hole=None):
    """A UTM DEM around (lon0, lat0) of plane((east - west) / res,
    (north_max - north) / res), with a NaN (nodata) node at raster index
    `hole`. Southern zones use the false northing (10 000 km), as EPSG 327xx
    rasters do. Returns (west, north_max)."""
    e, n = tgeo.utm_from_lonlat(np.array([lon0]), np.array([lat0]))
    e0, n0 = float(e[0]), float(n[0])
    south = lat0 < 0
    if south and n0 < 0:
        n0 += 10e6
    bbx = {"xmin": e0 - half, "xmax": e0 + half, "ymin": n0 - half, "ymax": n0 + half}
    h, w = tgeo.utm_bbox_shape(bbx, res)
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    z = plane(jj, ii).astype(np.float32)
    assert np.array_equal(z, plane(jj, ii))
    if hole is not None:
        z[hole] = np.nan
    zone = tgeo.latlon_to_zone_number(lat0, lon0)
    epsg = (32700 if south else 32600) + zone
    tiffwrite.write_georeferenced_raster_utm_bbox(path, z, bbx, epsg=epsg, resolution=res)
    return bbx["xmin"], bbx["ymax"]


def _utm_plane(plane, corner, lons, lats, res=32.0):
    """The plane's value at (lon, lat), from its formula."""
    e, n = tgeo.utm_from_lonlat(np.asarray(lons, float), np.asarray(lats, float))
    n = np.where(n < 0, n + 10e6, n)
    return plane((e - corner[0]) / res, (corner[1] - n) / res)


def _geographic_dem(path, lon0, lat0, plane, step=2e-4, n=101, hole=None, nodata=-32768.0):
    """A lon/lat (EPSG:4326) DEM of plane((lon - west) / step,
    (north - lat) / step) with a numeric nodata value at raster index
    `hole`. Returns (west, north)."""
    west, north = lon0 - step * (n - 1) / 2, lat0 + step * (n - 1) / 2
    jj, ii = np.meshgrid(np.arange(n), np.arange(n))
    z = plane(jj, ii).astype(np.float32)
    if hole is not None:
        z[hole] = nodata
    keys = [1, 1, 0, 3, 1024, 0, 1, 2, 1025, 0, 1, 1, 2048, 0, 1, 4326]
    tiffwrite.write_tiff(path, z, [
        tiffwrite._entry(tiffwrite.T_MODEL_PIXEL_SCALE, 12, [step, step, 0.0]),
        tiffwrite._entry(tiffwrite.T_MODEL_TIEPOINT, 12, [0.0, 0.0, 0.0, west, north, 0.0]),
        tiffwrite._entry(tiffwrite.T_GEO_KEYS, 3, keys),
        tiffwrite._entry(tiffwrite.T_GDAL_NODATA, 2, "{:g}".format(nodata)),
    ])
    return west, north


def _samples(lon0, lat0, span, n=60, seed=0):
    """Sample points over 1.6x the DEM's span: some fall outside it."""
    rng = np.random.RandomState(seed)
    return lon0 + rng.uniform(-0.8, 0.8, n) * span, lat0 + rng.uniform(-0.8, 0.8, n) * span


def _assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("lon0,lat0", [(2.0, 48.0), (18.4, -33.9)], ids=["north", "south"])
def test_utm_dem_matches_jax(tmp_path, lon0, lat0):
    """A UTM DEM (north and south of the equator) with a nodata cell:
    equal samples, NaN out of the raster and around the hole, and inside
    the plane's value."""
    plane = _plane(120.0, 0.25, -0.125)
    path = str(tmp_path / "dem.tif")
    corner = _utm_dem(path, lon0, lat0, plane, hole=(100, 100))
    td, jd = tdem.GeoTiffDEM(path), jdem.GeoTiffDEM(path)
    assert td.epsg == jd.epsg and td.epsg // 100 == (327 if lat0 < 0 else 326)
    lons, lats = _samples(lon0, lat0, 0.06)
    zt, zj = td.altitudes(lons, lats), jd.altitudes(lons, lats)
    _assert_same(zt, zj)
    assert np.isnan(zt).any() and np.isfinite(zt).sum() > 20
    ok = np.isfinite(zt)
    np.testing.assert_allclose(zt[ok], _utm_plane(plane, corner, lons, lats)[ok], rtol=0,
                               atol=1e-6)
    # a sample next to the NaN node is NaN in both
    zone = tgeo.latlon_to_zone_number(lat0, lon0)
    hole_n = corner[1] - 100.5 * 32.0 - (10e6 if lat0 < 0 else 0.0)
    lon_h, lat_h = tgeo.lonlat_from_utm(np.array([corner[0] + 100.5 * 32.0]),
                                        np.array([hole_n]), zone)
    assert np.isnan(td.altitudes(lon_h, lat_h)[0]) and np.isnan(jd.altitudes(lon_h, lat_h)[0])


def test_geographic_dem_matches_jax(tmp_path):
    """A lon/lat DEM with a numeric nodata value: equal samples, NaN out of
    range and at nodata, the plane's value inside (float32 nodes)."""
    lon0, lat0 = -72.71, 11.02
    plane = _plane(300.0, 0.5, 0.75)
    path = str(tmp_path / "geo_dem.tif")
    west, north = _geographic_dem(path, lon0, lat0, plane, hole=(50, 60))
    td, jd = tdem.GeoTiffDEM(path), jdem.GeoTiffDEM(path)
    assert td.epsg is None and td.nodata == jd.nodata == -32768.0
    lons, lats = _samples(lon0, lat0, 0.02)
    lons = np.append(lons, west + 60.5 * 2e-4)
    lats = np.append(lats, north - 50.5 * 2e-4)
    zt, zj = td.altitudes(lons, lats), jd.altitudes(lons, lats)
    _assert_same(zt, zj)
    assert np.isnan(zt[-1]) and np.isnan(zt).sum() < zt.size
    ok = np.isfinite(zt)
    np.testing.assert_allclose(zt[ok], plane((lons - west) / 2e-4, (north - lats) / 2e-4)[ok],
                               rtol=0, atol=1e-6)


def test_make_alt_getter_with_a_dem(tmp_path):
    """The pipeline's hook with a DEM: the plane's value at the RPC centre,
    as in JAX; an image outside the raster falls back to the clamped RPC
    altitude offset (default_altitude)."""
    lon0, lat0 = -72.71, 11.02
    plane = _plane(80.0, 0.125, 0.0625)
    path = str(tmp_path / "dem.tif")
    corner = _utm_dem(path, lon0, lat0, plane, half=5024.0)

    class Im:
        def __init__(self, rpc):
            self.rpc = rpc

    gt, gj = tdem.make_alt_getter(dem_path=path), jdem.make_alt_getter(dem_path=path)
    for dlon, dlat in ((0.0, 0.0), (0.02, -0.013)):
        zt = gt(Im(trpc(lon0=lon0 + dlon, lat0=lat0 + dlat)))
        zj = gj(Im(jrpc(lon0=lon0 + dlon, lat0=lat0 + dlat)))
        assert zt == zj
        assert abs(zt - float(_utm_plane(plane, corner, [lon0 + dlon], [lat0 + dlat])[0])) < 1e-6
    far_t, far_j = trpc(lon0=lon0 + 1.0, lat0=lat0), jrpc(lon0=lon0 + 1.0, lat0=lat0)
    assert gt(Im(far_t)) == gj(Im(far_j)) == default_altitude(far_t)


def test_make_alt_getter_without_a_source():
    """No DEM and no srtm4: no getter, in both packages."""
    assert (tdem.make_alt_getter() is None) == (jdem.make_alt_getter() is None)
    assert tdem.make_alt_getter() is None or tdem.srtm4_available()


def _write_pgm(path, grid, offset=-108.0, scale=0.003):
    """A GeographicLib-style geoid .pgm of `grid` (tests/test_geoid.py)."""
    h, w = grid.shape
    pix = np.round((grid - offset) / scale).astype(">u2")
    with open(path, "wb") as f:
        f.write(b"P5\n")
        f.write(b"# Geoid file in PGM format for the GeographicLib::Geoid class\n")
        f.write("# Offset {}\n".format(offset).encode())
        f.write("# Scale {}\n".format(scale).encode())
        f.write("{} {}\n65535\n".format(w, h).encode())
        f.write(pix.tobytes())


@pytest.fixture()
def pgm(tmp_path):
    h, w = 181, 361
    lat = np.linspace(90, -90, h)[:, None] * np.pi / 180
    lon = np.linspace(0, 360, w)[None, :] * np.pi / 180
    grid = 10 * np.sin(lat) + 5 * np.cos(lon) - 20 + 0 * (lat + lon)
    path = str(tmp_path / "egm96-60.pgm")
    _write_pgm(path, grid)
    return path, grid


def test_geoid_grid_matches_jax(pgm):
    """The .pgm reader and the bilinear undulation: equal to JAX's, the
    reader within the grid's quantization (scale 0.003 m) of the source."""
    path, grid = pgm
    g = tgeoid.load_geoid_pgm(path)
    _assert_same(g, jgeoid.load_geoid_pgm(path))
    np.testing.assert_allclose(g, grid, atol=0.003)
    lats = np.array([45.0, -30.5, 11.02, 90.0, -90.0, 0.0])
    lons = np.array([10.0, 123.25, -72.71, 0.0, 359.9, -180.0])
    _assert_same(tgeoid.geoid_undulation(lats, lons, grid_path=path),
                 jgeoid.geoid_undulation(lats, lons, grid_path=path))


def test_geoid_reader_rejects_what_jax_rejects(tmp_path):
    """Malformed grids raise ValueError, a missing one FileNotFoundError."""
    bad8 = str(tmp_path / "bad8.pgm")
    with open(bad8, "wb") as f:
        f.write(b"P5\n# Offset 0\n# Scale 1\n2 2\n255\n" + bytes(4))
    nohdr = str(tmp_path / "nohdr.pgm")
    with open(nohdr, "wb") as f:
        f.write(b"P5\n2 2\n65535\n" + struct.pack(">4H", 1, 2, 3, 4))
    for p in (bad8, nohdr):
        with pytest.raises(ValueError):
            jgeoid.load_geoid_pgm(p)
        with pytest.raises(ValueError):
            tgeoid.load_geoid_pgm(p)
    with pytest.raises(FileNotFoundError):
        tgeoid.geoid_undulation(0.0, 0.0, grid_path=str(tmp_path / "none.pgm"))


def test_geoid_to_ellipsoid_matches_jax(pgm, monkeypatch):
    """With geoid_pgm, with SATBA_GEOID_PGM, and without a grid (no pyproj
    here): the JAX package's values and its error."""
    path, _ = pgm
    lat, lon, z = np.array([45.0, -12.5]), np.array([10.0, 200.0]), np.array([100.0, -3.0])
    _assert_same(tgeo.geoid_to_ellipsoid(lat, lon, z, geoid_pgm=path),
                 jgeo.geoid_to_ellipsoid(lat, lon, z, geoid_pgm=path))
    monkeypatch.setenv("SATBA_GEOID_PGM", path)
    zt = tgeo.geoid_to_ellipsoid(45.0, 10.0, 100.0)
    _assert_same(zt, jgeo.geoid_to_ellipsoid(45.0, 10.0, 100.0))
    expect = 100.0 + 10 * np.sin(np.radians(45.0)) + 5 * np.cos(np.radians(10.0)) - 20
    assert abs(float(zt[0]) - expect) < 0.05
    monkeypatch.delenv("SATBA_GEOID_PGM")
    try:
        import pyproj  # noqa: F401
    except ImportError:
        for fn in (tgeo.geoid_to_ellipsoid, jgeo.geoid_to_ellipsoid):
            with pytest.raises(NotImplementedError, match="SATBA_GEOID_PGM"):
                fn(45.0, 10.0, 100.0)
