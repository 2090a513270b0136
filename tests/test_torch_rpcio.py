"""Parity of the port's RPC files and IO helpers with the JAX package's.

The same coefficients, drawn from a seed, go through both packages'
writers and readers. Text files must be byte-identical and read back to
identical float64 (both format every value with `{:.12f}` and parse it
with `float`); the projections allow 1e-9 px, the libm tolerance of
tests/test_torch_geometry.py.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from sat_bundleadjust_tpu.models import cameras as jcam
from sat_bundleadjust_tpu.models import rpc as jrpc
from sat_bundleadjust_tpu.utils import io as jio
from sat_bundleadjust_tpu.utils import tiffwrite as jtiffwrite
from sat_bundleadjust_tpu.utils.demo import make_synthetic_rpc as jmake_rpc

from sat_bundleadjust_tpu_torch.models import cameras as tcam
from sat_bundleadjust_tpu_torch.models import rpc as trpc
from sat_bundleadjust_tpu_torch.utils import io as tio
from sat_bundleadjust_tpu_torch.utils import tiffwrite as ttiffwrite


def _random_rpc(seed):
    """A demo RPC with every coefficient perturbed (numpy fields), so that
    every written digit is exercised."""
    rng = np.random.RandomState(seed)
    r = jmake_rpc(view_dx=rng.uniform(-300, 300), view_dy=rng.uniform(-300, 300))
    fields = {k: np.asarray(getattr(r, k), np.float64) + rng.normal(0, 1e-3, np.shape(getattr(r, k)))
              for k in trpc.RPCModel._fields[:4]}
    fields.update({k: np.float64(getattr(r, k)) * (1 + rng.uniform(-1e-3, 1e-3))
                   for k in trpc.RPCModel._fields[4:]})
    return fields


def _same_fields(a, b):
    for k in trpc.RPCModel._fields:
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype == np.float64 and np.array_equal(x, y), k


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rpc_text_and_json_byte_identical(tmp_path, seed):
    fields = _random_rpc(seed)
    j, t = jrpc.RPCModel(**fields), trpc.RPCModel(**fields)
    for ext, jw, tw in ((".rpc", jrpc.write_rpc_file, trpc.write_rpc_file),
                        (".json", jrpc.write_rpc_json, trpc.write_rpc_json)):
        pj, pt = str(tmp_path / ("jax" + ext)), str(tmp_path / ("torch" + ext))
        jw(j, pj)
        tw(t, pt)
        assert _read(pj) == _read(pt), ext
    # tensor fields write the same text
    pt2 = str(tmp_path / "tensor.rpc")
    trpc.write_rpc_file(trpc.map_rpc(torch.as_tensor, t), pt2)
    assert _read(pt2) == _read(str(tmp_path / "jax.rpc"))
    assert trpc.rpc_to_dict(t) == jrpc.rpc_to_dict(j)


@pytest.mark.parametrize("seed", [0, 1])
def test_rpc_files_read_both_ways(tmp_path, seed):
    fields = _random_rpc(seed)
    j = jrpc.RPCModel(**fields)
    t = trpc.RPCModel(**fields)
    jrpc.write_rpc_file(j, str(tmp_path / "j.rpc"))
    trpc.write_rpc_file(t, str(tmp_path / "t.rpc"))
    jrpc.write_rpc_json(j, str(tmp_path / "j.json"))
    for name in ("j.rpc", "t.rpc"):
        _same_fields(trpc.rpc_from_rpc_file(str(tmp_path / name)),
                     jrpc.rpc_from_rpc_file(str(tmp_path / name)))
    _same_fields(trpc.rpc_from_json_file(str(tmp_path / "j.json")),
                 jrpc.rpc_from_json_file(str(tmp_path / "j.json")))
    # the rpcm json naming
    d = jrpc.rpc_to_dict(j)
    rpcm = {{"line_num": "row_num", "line_den": "row_den", "samp_num": "col_num",
             "samp_den": "col_den"}.get(k, k): v for k, v in d.items()}
    jio.save_dict_to_json(rpcm, str(tmp_path / "rpcm.json"))
    _same_fields(trpc.rpc_from_json_file(str(tmp_path / "rpcm.json")),
                 jrpc.rpc_from_json_file(str(tmp_path / "rpcm.json")))


def test_geotiff_dict_and_scale(tmp_path):
    fields = _random_rpc(3)
    j, t = jrpc.RPCModel(**fields), trpc.RPCModel(**fields)
    dj, dt = jrpc.rpc_to_geotiff_dict(j), trpc.rpc_to_geotiff_dict(t)
    assert dj == dt
    _same_fields(trpc.rpc_from_geotiff_dict(dt), jrpc.rpc_from_geotiff_dict(dj))
    as_lists = {k: (v.split() if "COEFF" in k else v) for k, v in dt.items()}
    _same_fields(trpc.rpc_from_geotiff_dict(as_lists), jrpc.rpc_from_geotiff_dict(as_lists))
    for alpha in (0.5, 2.0, 3.7):
        _same_fields(trpc.scale_rpc(t, alpha), jrpc.scale_rpc(j, alpha))


def test_geotiff_rpc_tag_roundtrip(tmp_path):
    """update_geotiff_rpc writes the same bytes in both packages, and both
    rpc_from_geotiff read the tag back to the same f64."""
    fields = _random_rpc(4)
    rng = np.random.RandomState(4)
    base = (rng.uniform(0, 255, (40, 60))).astype(np.uint8)
    paths = {}
    for name, fn, rpc in (("jax", jtiffwrite.update_geotiff_rpc, jrpc.RPCModel(**fields)),
                          ("torch", ttiffwrite.update_geotiff_rpc, trpc.RPCModel(**fields))):
        paths[name] = str(tmp_path / (name + ".tif"))
        Image.fromarray(base).save(paths[name])
        fn(paths[name], rpc)
    assert _read(paths["jax"]) == _read(paths["torch"])
    _same_fields(tio.rpc_from_geotiff(paths["torch"]), jio.rpc_from_geotiff(paths["torch"]))
    Image.fromarray(base).save(str(tmp_path / "plain.tif"))
    with pytest.raises(IOError):
        tio.rpc_from_geotiff(str(tmp_path / "plain.tif"))


def test_save_and_load_rpcs_from_dir(tmp_path):
    rpcs = [trpc.RPCModel(**_random_rpc(s)) for s in range(3)]
    names = [str(tmp_path / "img" / "{}_x.tif".format(s)) for s in range(3)]
    out = str(tmp_path / "rpcs")
    tio.save_rpcs([os.path.join(out, tio.get_id(n) + ".rpc_adj") for n in names], rpcs)
    back_t = tio.load_rpcs_from_dir(names, out, extension="rpc_adj", verbose=False)
    back_j = jio.load_rpcs_from_dir(names, out, extension="rpc_adj", verbose=False)
    for a, b in zip(back_t, back_j):
        _same_fields(a, b)
    assert tio.add_suffix_to_fname("/a/b/c.tif", "_x") == jio.add_suffix_to_fname("/a/b/c.tif", "_x")


def test_ply_json_geojson_helpers(tmp_path):
    rng = np.random.RandomState(5)
    pts = rng.normal(0, 1e6, (50, 3))
    tio.write_point_cloud_ply(str(tmp_path / "t.ply"), pts)
    jio.write_point_cloud_ply(str(tmp_path / "j.ply"), pts)
    assert _read(str(tmp_path / "t.ply")) == _read(str(tmp_path / "j.ply"))
    back = tio.read_point_cloud_ply(str(tmp_path / "j.ply"))
    assert np.array_equal(back, jio.read_point_cloud_ply(str(tmp_path / "t.ply")))
    np.testing.assert_array_equal(back, pts)  # repr of a float64 round-trips exactly
    color = np.array([10, 20, 30])
    tio.write_point_cloud_ply(str(tmp_path / "tc.ply"), pts[:3], color=color)
    jio.write_point_cloud_ply(str(tmp_path / "jc.ply"), pts[:3], color=color)
    assert _read(str(tmp_path / "tc.ply")) == _read(str(tmp_path / "jc.ply"))

    d = {"a": [1.5, 2.0], "b": {"c": "x"}}
    tio.save_dict_to_json(d, str(tmp_path / "d" / "t.json"))
    jio.save_dict_to_json(d, str(tmp_path / "d" / "j.json"))
    assert _read(str(tmp_path / "d" / "t.json")) == _read(str(tmp_path / "d" / "j.json"))
    assert tio.load_dict_from_json(str(tmp_path / "d" / "j.json")) == d

    from sat_bundleadjust_tpu.utils.geo import geojson_polygon

    g = geojson_polygon(np.array([[-72.7, 11.0], [-72.6, 11.0], [-72.6, 11.1], [-72.7, 11.1]]))
    tio.save_geojson(str(tmp_path / "t.geojson"), g)
    jio.save_geojson(str(tmp_path / "j.geojson"), g)
    assert _read(str(tmp_path / "t.geojson")) == _read(str(tmp_path / "j.geojson"))
    gt, gj = tio.load_geojson(str(tmp_path / "j.geojson")), jio.load_geojson(str(tmp_path / "t.geojson"))
    assert gt["coordinates"] == gj["coordinates"]
    np.testing.assert_array_equal(gt["center"], gj["center"])


def test_aoi_from_multiple_images_and_projection():
    """The union of four footprints: the same polygon (the footprints go
    through RPC localization, so vertices agree to 1e-12 deg). The RPC
    projection of ECEF points: 1e-9 px."""
    rpcs = [jmake_rpc(view_dx=250.0 * np.cos(k), view_dy=250.0 * np.sin(k), img_halfsize=(200, 150))
            for k in range(4)]
    off = {"col0": 0.0, "row0": 0.0, "width": 400, "height": 300}
    ims_j, ims_t = [], []
    for r in rpcs:
        a = jcam.SatelliteImage("x.tif", r, offset=dict(off))
        b = tcam.SatelliteImage("x.tif", trpc.RPCModel(*r), offset=dict(off))
        a.set_footprint(alt=50.0)
        b.set_footprint(alt=50.0)
        ims_j.append(a)
        ims_t.append(b)
    aj = jio.load_aoi_from_multiple_images(ims_j)
    at = tio.load_aoi_from_multiple_images(ims_t)
    cj, ct = np.array(aj["coordinates"][0]), np.array(at["coordinates"][0])
    assert cj.shape == ct.shape
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-12)

    rng = np.random.RandomState(6)
    from sat_bundleadjust_tpu_torch.models.ellipsoid import latlon_to_ecef_np

    pts = np.stack(latlon_to_ecef_np(11.02 + rng.uniform(-0.01, 0.01, 30),
                                     -72.71 + rng.uniform(-0.01, 0.01, 30),
                                     rng.uniform(0, 100, 30)), axis=1)
    pj = np.asarray(jcam.apply_rpc_projection(rpcs[1], pts))
    pn = tcam.apply_rpc_projection_np(trpc.RPCModel(*rpcs[1]), pts)
    pt = tcam.apply_rpc_projection(trpc.map_rpc(lambda f: torch.as_tensor(np.asarray(f)),
                                                trpc.RPCModel(*rpcs[1])),
                                   torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(pn, np.asarray(jcam.apply_rpc_projection_np(rpcs[1], pts)),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-9)
