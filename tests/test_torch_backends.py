"""Parity of the port's other backends with the JAX package's, on the CPU:
the opencv detector, the AOI keypoint masks (FT_kp_aoi), the lightglue
matcher (against the JAX package's stub matcher; the real package and its
weights are not in the repository), local_window's error, and a whole
Scene run with aoi_geojson, FT_kp_aoi, opencv detection and a DEM.

The scene: four 300x400 views of a texture at altitude 0 rendered by
utils/demo.render_synthetic_images, written as uint8 TIFFs with their RPCs
(biases of up to +-3 px on views 1-3); an AOI that covers the central half
of view 0's footprint; a UTM DEM that is a tilted plane around altitude 0
(every node exact in float32).

Tolerances: cv2 runs in both packages on the same equalized pixels, the
masks are the same fill of vertices projected by two float64 RPC codes
(libm last bits, far from a pixel's rounding) and, on the CPU, both
packages match pairs with the same matcher: keypoints, masks, pairwise
matches and tracks must be identical. The DEM sample is host numpy in both:
identical, and the plane's value within 1e-6 m. The Scene's .rpc_adj files
must project a ground grid within 1e-2 px of the JAX run's
(tests/test_torch_e2e.py's bar; measured here: 2.1e-3 px, the LM of the two
runs stopping one iteration apart, 18 against 19, in the flat valley of
ROADMAP Queue 3's "rotations at convergence").
"""

import glob
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import sat_bundleadjust_tpu  # noqa: F401  (enables float64 in JAX)
from sat_bundleadjust_tpu.models.cameras import SatelliteImage as JImage
from sat_bundleadjust_tpu.models.rpc import RPCModel as JRPCModel
from sat_bundleadjust_tpu.tracks import detection as jdet
from sat_bundleadjust_tpu.tracks import lightglue as jlg
from sat_bundleadjust_tpu.tracks import matching as jmatching
from sat_bundleadjust_tpu.tracks.pipeline import FeatureTracksPipeline as JPipeline
from sat_bundleadjust_tpu.utils import io as jio

from sat_bundleadjust_tpu_torch.models.cameras import SatelliteImage as TImage
from sat_bundleadjust_tpu_torch.models.rpc import rpc_projection_np, write_rpc_file
from sat_bundleadjust_tpu_torch.ops import match as tmatch_ops
from sat_bundleadjust_tpu_torch.pipeline import default_altitude
from sat_bundleadjust_tpu_torch.tracks import detection as tdet
from sat_bundleadjust_tpu_torch.tracks import lightglue as tlg
from sat_bundleadjust_tpu_torch.tracks import matching as tmatching
from sat_bundleadjust_tpu_torch.tracks.pipeline import FeatureTracksPipeline as TPipeline
from sat_bundleadjust_tpu_torch.utils import demo as tdemo
from sat_bundleadjust_tpu_torch.utils import geo as tgeo
from sat_bundleadjust_tpu_torch.utils import io as tio
from sat_bundleadjust_tpu_torch.utils import tiffwrite
from sat_bundleadjust_tpu_torch.utils.polygons import Polygon

torch.set_num_threads(1)
H, W, N_CAM, ALT = 300, 400, 4, 0.0
DEM_RES = 32.0
DEM_PLANE = (0.0, 1.0 / 64, -1.0 / 128)  # z = a + b * column + c * row of the DEM raster
TRACKS = {"FT_sift_detection": "opencv", "FT_sift_matching": "bruteforce", "FT_kp_max": 3000,
          "FT_kp_aoi": True, "FT_save": False, "FT_reset": True}
GRID_LON = -72.71 + np.linspace(-0.01, 0.01, 9)
GRID_LAT = 11.02 + np.linspace(-0.01, 0.01, 9)


def _central_half(rpc):
    """A lon/lat geojson of the central half (by area) of rpc's footprint
    at altitude ALT."""
    from sat_bundleadjust_tpu_torch.models.rpc import rpc_localization_np

    lon, lat = rpc_localization_np(rpc, np.array([0.0, W, W, 0.0]), np.array([0.0, 0.0, H, H]),
                                   np.full(4, ALT))
    c = np.array([lon.mean(), lat.mean()])
    ring = c + (np.stack([lon, lat], axis=1) - c) * np.sqrt(0.5)
    return tgeo.geojson_polygon(ring)


def write_plane_dem(path, lon0, lat0, plane, res, half):
    """A UTM GeoTIFF DEM around (lon0, lat0): node (row i, column j) holds
    plane[0] + plane[1] * j + plane[2] * i (dyadic, so exact in float32).
    Returns the plane's value at (lon, lat) as a function."""
    e, n = tgeo.utm_from_lonlat(np.array([lon0]), np.array([lat0]))
    bbx = {"xmin": float(e[0]) - half, "xmax": float(e[0]) + half,
           "ymin": float(n[0]) - half, "ymax": float(n[0]) + half}
    h, w = tgeo.utm_bbox_shape(bbx, res)
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    z = plane[0] + plane[1] * jj + plane[2] * ii
    assert np.array_equal(z.astype(np.float32), z)
    epsg = tgeo.epsg_code_from_utm_zone(tgeo.zonestring_from_lonlat(lon0, lat0))
    tiffwrite.write_georeferenced_raster_utm_bbox(path, z.astype(np.float32), bbx, epsg, res)

    def value(lon, lat):
        ee, nn = tgeo.utm_from_lonlat(np.atleast_1d(lon), np.atleast_1d(lat))
        return plane[0] + plane[1] * (ee - bbx["xmin"]) / res + plane[2] * (bbx["ymax"] - nn) / res

    return value


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("backends"))
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    ims, rpcs = tdemo.render_synthetic_images(n_cam=N_CAM, h=H, w=W, seed=0, alt=ALT, device="cpu")
    rng = np.random.RandomState(5)
    paths, biased = [], []
    for k, (im, rpc) in enumerate(zip(ims, rpcs)):
        name = "20200413_1514{:02d}_view{}".format(10 + k, k)
        paths.append(os.path.join(img_dir, name + ".tif"))
        Image.fromarray((im * 255).astype(np.uint8)).save(paths[-1])
        bias = np.zeros(2) if k == 0 else rng.uniform(-3, 3, 2)
        biased.append(rpc._replace(col_offset=rpc.col_offset + bias[0],
                                   row_offset=rpc.row_offset + bias[1]))
        write_rpc_file(biased[-1], os.path.join(img_dir, name + ".rpc"))
    aoi = _central_half(rpcs[0])
    aoi_path = os.path.join(root, "aoi.json")
    tio.save_geojson(aoi_path, aoi)
    dem_path = os.path.join(root, "dem.tif")
    dem_value = write_plane_dem(dem_path, -72.71, 11.02, DEM_PLANE, DEM_RES, 8000.0)
    return {"root": root, "img_dir": img_dir, "paths": paths, "rpcs": rpcs, "biased": biased,
            "aoi": aoi, "aoi_path": aoi_path, "dem_path": dem_path, "dem_value": dem_value}


def _images(cls, scene):
    out = []
    for p, r in zip(scene["paths"], scene["biased"]):
        if cls is JImage:
            r = _jax_rpc(r)
        im = cls(p, r, offset={"col0": 0, "row0": 0, "height": H, "width": W})
        im.set_footprint(alt=ALT)
        im.set_camera_center()
        out.append(im)
    return out


def _jax_rpc(rpc):
    return JRPCModel(*[jnp.asarray(np.asarray(f, np.float64)) for f in rpc])


def _masks(scene):
    return [tio.get_binary_mask_from_aoi_lonlat_within_image(H, W, r, scene["aoi"], alt=ALT)
            for r in scene["biased"]]


def _inside(features, mask, backend):
    """Which keypoints lie inside the mask, by the detector's own pixel
    rule: cv2 tests the pixel of the rounded position (its
    KeyPointsFilter::runByPixelsMask), the package's SIFT that of the
    truncated one (tracks/detection._apply_mask)."""
    xy = features[~np.isnan(features[:, 0]), :2]
    px = (xy + 0.5 if backend == "opencv" else xy).astype(np.int64)
    px[:, 0] = np.clip(px[:, 0], 0, mask.shape[1] - 1)
    px[:, 1] = np.clip(px[:, 1], 0, mask.shape[0] - 1)
    return mask[px[:, 1], px[:, 0]] > 0


def test_aoi_masks_match_jax(scene):
    """get_binary_mask_from_aoi_lonlat_within_image: JAX's masks, each
    covering 20-80% of its view."""
    for r, m in zip(scene["biased"], _masks(scene)):
        mj = jio.get_binary_mask_from_aoi_lonlat_within_image(H, W, _jax_rpc(r), scene["aoi"],
                                                              alt=ALT)
        np.testing.assert_array_equal(m, mj)
        assert m.dtype == np.uint8 and 0.2 < m.mean() < 0.8, m.mean()


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_detect_opencv_matches_jax(scene, masked):
    """cv2 SIFT on the same equalized frame, with and without a mask:
    identical rows; the mask keeps only keypoints inside it."""
    image = tio.load_image(scene["paths"][1], equalize=True)
    mask = _masks(scene)[1] if masked else None
    ft, fj = tdet.detect_opencv(image, mask), jdet.detect_opencv(image, mask)
    np.testing.assert_array_equal(ft, fj)
    assert ft.shape[0] > 500
    if masked:
        assert _inside(ft, mask, "opencv").all()


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_opencv_sequence_matches_jax(scene, tmp_path, masked):
    """detect_features_image_sequence with opencv: JAX's arrays (NaN-padded
    to FT_kp_max), with descriptors that are integers in 0..255, so that
    the staged int8 2-NN kernel takes them on the card."""
    mask_paths = None
    if masked:
        mask_paths = []
        for k, m in enumerate(_masks(scene)):
            mask_paths.append(str(tmp_path / "m{}.npy".format(k)))
            np.save(mask_paths[-1], m)
    offsets = [{"col0": 0, "row0": 0, "height": H, "width": W}] * N_CAM
    cfg = dict(TRACKS, FT_kp_aoi=masked)
    timing = {}
    ft = tdet.detect_features_image_sequence(scene["paths"], mask_paths, offsets, cfg,
                                             device="cpu", timing=timing)
    fj = jdet.detect_features_image_sequence(scene["paths"], mask_paths, offsets, dict(cfg))
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (TRACKS["FT_kp_max"], 132)
    assert timing["detector_s"] > 0
    assert tmatch_ops.stage_frames_for_matching(ft, device="cpu") is not None


def test_opencv_threads_equal_serial(scene):
    """FT_n_proc 3 (a thread pool) gives the serial run's arrays."""
    offsets = [{"col0": 0, "row0": 0, "height": H, "width": W}] * N_CAM
    serial = tdet.detect_features_image_sequence(scene["paths"], None, offsets,
                                                 dict(TRACKS, FT_n_proc=1), device="cpu")
    pooled = tdet.detect_features_image_sequence(scene["paths"], None, offsets,
                                                 dict(TRACKS, FT_n_proc=3), device="cpu")
    for a, b in zip(serial, pooled):
        np.testing.assert_array_equal(a, b)


def test_feature_tracks_pipeline_opencv_aoi_matches_jax(scene):
    """FeatureTracksPipeline with opencv, bruteforce and FT_kp_aoi on the
    4-view scene: the same masks/ files, keypoints, pairwise matches and
    tracks as JAX's; every kept keypoint inside its mask."""
    out = {}
    for tag, cls, pipe_cls, kw in (("jax", JImage, JPipeline, {}),
                                   ("torch", TImage, TPipeline, {"device": "cpu"})):
        d = os.path.join(scene["root"], "ft_" + tag)
        ft = pipe_cls(d, d, {"images": _images(cls, scene), "n_adj": 0, "aoi": scene["aoi"]},
                      tracks_config=dict(TRACKS), **kw)
        bundle, _ = ft.build_feature_tracks()
        masks = [np.load(p) for p in sorted(glob.glob(os.path.join(d, "masks", "*.npy")))]
        out[tag] = (bundle, masks)
    (bt, mt), (bj, mj) = out["torch"], out["jax"]
    assert len(mt) == len(mj) == N_CAM
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a, b)
    for f, m in zip(bt["features"], mt):
        inside = _inside(f, m, "opencv")
        assert inside.size > 100 and inside.all()
    for a, b in zip(bt["features"], bj["features"]):
        np.testing.assert_array_equal(a, b)
    assert bt["pairs_to_match"] == bj["pairs_to_match"]
    np.testing.assert_array_equal(bt["pairwise_matches"], bj["pairwise_matches"])
    assert bt["C"].shape[1] > 200
    np.testing.assert_array_equal(bt["C"], bj["C"])
    np.testing.assert_array_equal(bt["C_v2"], bj["C_v2"])


# ----------------------------------------------------------------------
# lightglue, with tests/test_lightglue.py's stub matcher
# ----------------------------------------------------------------------


def _features(n, seed=0, w=400, h=300):
    rng = np.random.RandomState(seed)
    f = np.zeros((n, 132))
    f[:, 0] = rng.uniform(0, w, n)
    f[:, 1] = rng.uniform(0, h, n)
    f[:, 2] = rng.uniform(1, 4, n)
    f[:, 3] = rng.uniform(0, 360, n)
    f[:, 4:] = rng.uniform(0, 255, (n, 128))
    return f


class _StubMatcher:
    """Minimal LightGlue stand-in: nearest neighbour on the RootSIFT
    descriptors (tests/test_lightglue.py)."""

    def eval(self):
        return self

    def to(self, device):
        return self

    def __call__(self, data):
        d0 = data["image0"]["descriptors"][0]
        d1 = data["image1"]["descriptors"][0]
        j = torch.cdist(d0, d1).argmin(dim=1)
        i = torch.arange(d0.shape[0])
        return {"matches": torch.stack([i, j], dim=1)[None],
                "scores": (1.0 / (1.0 + i.float()))[None]}


@pytest.fixture
def stub_lightglue(monkeypatch):
    mod = types.ModuleType("lightglue")
    mod.LightGlue = lambda features: _StubMatcher()
    monkeypatch.setitem(sys.modules, "lightglue", mod)
    for m in (tlg, jlg):
        m._MATCHER_CACHE.clear()
    yield mod
    for m in (tlg, jlg):
        m._MATCHER_CACHE.clear()


def test_lightglue_format_matches_jax():
    """sift_to_lightglue_format: JAX's tensors, RootSIFT on and off, NaN
    rows dropped."""
    f = np.vstack([_features(17), np.full((3, 132), np.nan)])
    for rootsift in (True, False):
        ft = tlg.sift_to_lightglue_format(f, image_size=(400, 300), device="cpu",
                                          rootsift=rootsift)
        fj = jlg.sift_to_lightglue_format(f, image_size=(400, 300), rootsift=rootsift)
        assert ft.keys() == fj.keys()
        for k in ft:
            assert torch.equal(ft[k], fj[k]), k
    assert ft["keypoints"].shape == (1, 17, 2)


def test_lightglue_matching_matches_jax(stub_lightglue):
    """A shuffled copy of a keypoint set: the same matches and counts as
    JAX's, and the shuffle recovered."""
    fi = _features(60, seed=1)
    perm = np.random.RandomState(2).permutation(60)
    fj = fi[perm]
    mt, nt, kt = tlg.lightglue_matching(fi, fj, ransac_thr=1.0, device="cpu")
    mj, nj, kj = jlg.lightglue_matching(fi, fj, ransac_thr=1.0)
    np.testing.assert_array_equal(mt, mj)
    assert (nt, kt) == (nj, kj) and nt == 60 and kt > 40
    assert np.all(perm[mt[:, 1]] == mt[:, 0])


def test_lightglue_max_matches(stub_lightglue):
    """max_matches keeps the most confident: JAX's 10 rows."""
    fi = _features(50, seed=3)
    mt, _, kt = tlg.lightglue_matching(fi, fi, ransac_thr=1.0, max_matches=10, device="cpu")
    mj, _, kj = jlg.lightglue_matching(fi, fi, ransac_thr=1.0, max_matches=10)
    assert kt == kj == 10
    np.testing.assert_array_equal(mt, mj)


def test_lightglue_missing_package_raises(monkeypatch):
    """Without the package: the JAX package's ImportError, from the matcher
    and from the port's method check before any stage runs."""
    monkeypatch.setitem(sys.modules, "lightglue", None)
    assert not tlg.lightglue_available()
    for fn, kw in ((tlg.lightglue_matching, {"device": "cpu"}), (jlg.lightglue_matching, {})):
        with pytest.raises(ImportError, match="LightGlue") as info:
            fn(_features(10), _features(10), **kw)
    assert str(info.value) == tlg.MISSING_PACKAGE
    with pytest.raises(ImportError, match="LightGlue"):
        tmatching._check_method("lightglue")


def test_lightglue_dispatch(stub_lightglue, scene):
    """FT_sift_matching 'lightglue' through match_kp_within_utm_polygon
    (JAX's result) and through match_stereo_pairs on the scene's opencv
    keypoints (one pair at a time: the per-pair function's matches)."""
    fi = _features(40, seed=4)
    utm = np.stack([np.linspace(0, 100, 40)] * 2, axis=1)
    poly = Polygon(np.array([[-1, -1], [101, -1], [101, 101], [-1, 101]], float))
    cfg = {"FT_sift_matching": "lightglue", "FT_ransac": 1.0}
    mt, nt = tmatching.match_kp_within_utm_polygon(fi, fi, utm, utm, poly, cfg, device="cpu")
    mj, nj = jmatching.match_kp_within_utm_polygon(fi, fi, utm, utm, poly, cfg)
    np.testing.assert_array_equal(mt, mj)
    assert nt == nj and mt.shape[0] > 20 and np.all(mt[:, 0] == mt[:, 1])

    ims = _images(TImage, scene)
    offsets = [im.offset for im in ims]
    feats = tdet.detect_features_image_sequence(scene["paths"], None, offsets, dict(TRACKS),
                                                device="cpu")
    utms = [tmatching.keypoints_to_utm_coords(f, im.rpc, im.offset, ALT) for f, im in zip(feats, ims)]
    fps = [{"geojson": tgeo.utm_geojson_from_lonlat_geojson(im.lonlat_geojson), "z": ALT}
           for im in ims]
    pairs = [(0, 1), (1, 2)]
    cfg = dict(TRACKS, FT_sift_matching="lightglue", FT_ransac=0.3)
    pm = tmatching.match_stereo_pairs(pairs, feats, fps, utms, cfg, device="cpu")
    for i, j in pairs:
        poly = tgeo.geojson_to_polygon(fps[i]["geojson"]).intersection(
            tgeo.geojson_to_polygon(fps[j]["geojson"]))
        m, _ = tmatching.match_kp_within_utm_polygon(feats[i], feats[j], utms[i], utms[j], poly,
                                                     cfg, device="cpu")
        rows = pm[(pm[:, 2] == i) & (pm[:, 3] == j), :2]
        assert m is not None and m.shape[0] > 0
        np.testing.assert_array_equal(rows, m)


def test_local_window_raises_as_jax(scene):
    """local_window: the JAX package's NotImplementedError and reason, from
    the per-pair matcher and before any stage of the port's pipeline."""
    fi = _features(20)
    utm = np.stack([np.linspace(0, 100, 20)] * 2, axis=1)
    poly = Polygon(np.array([[-1, -1], [101, -1], [101, 101], [-1, 101]], float))
    cfg = {"FT_sift_matching": "local_window", "FT_ransac": 1.0}
    with pytest.raises(NotImplementedError) as jinfo:
        jmatching.match_kp_within_utm_polygon(fi, fi, utm, utm, poly, cfg)
    with pytest.raises(NotImplementedError) as tinfo:
        tmatching.match_kp_within_utm_polygon(fi, fi, utm, utm, poly, cfg, device="cpu")
    assert str(tinfo.value) == str(jinfo.value) and "siftu" in str(tinfo.value)
    d = os.path.join(scene["root"], "ft_local_window")
    with pytest.raises(NotImplementedError, match="siftu"):
        TPipeline(d, d, {"images": _images(TImage, scene), "n_adj": 0, "aoi": None},
                  tracks_config=dict(TRACKS, FT_sift_matching="local_window"), device="cpu")


# ----------------------------------------------------------------------
# a whole Scene run with the options, through both packages
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene_runs(scene):
    import sat_bundleadjust_tpu
    import sat_bundleadjust_tpu_torch

    out = {}
    for pkg in ("jax", "torch"):
        cfg = {"geotiff_dir": scene["img_dir"], "rpc_dir": scene["img_dir"], "rpc_src": "txt",
               "output_dir": os.path.join(scene["root"], "scene_" + pkg),
               "ba_method": "ba_bruteforce", "aoi_geojson": scene["aoi_path"],
               "dem_path": scene["dem_path"], "FT_kp_aoi": True, "FT_sift_detection": "opencv",
               "FT_sift_matching": "bruteforce", "FT_kp_max": 3000, "save_figures": False}
        path = os.path.join(scene["root"], "config_{}.json".format(pkg))
        with open(path, "w") as f:
            json.dump(cfg, f)
        run = (sat_bundleadjust_tpu.main(path) if pkg == "jax"
               else sat_bundleadjust_tpu_torch.main(path, device="cpu"))
        out[pkg] = (run, os.path.join(cfg["output_dir"], "ba_bruteforce"))
    return out


def _rpc_adj_projections(ba_dir):
    from sat_bundleadjust_tpu_torch.models.rpc import rpc_from_rpc_file

    files = sorted(glob.glob(os.path.join(ba_dir, "rpcs_adj", "*.rpc_adj")))
    LO, LA = np.meshgrid(GRID_LON, GRID_LAT)
    alts = np.full(LO.size, ALT)
    return files, [np.stack(rpc_projection_np(rpc_from_rpc_file(f), LO.ravel(), LA.ravel(), alts),
                            axis=1) for f in files]


def test_scene_with_aoi_opencv_and_dem_matches_jax(scene, scene_runs):
    """The CLI's options together: the same masks and tracks as the JAX
    run, footprint altitudes from the DEM (JAX's, and the plane's value at
    each RPC centre within 1e-6 m), the error brought down, and .rpc_adj
    files within 1e-2 px of JAX's on a ground grid."""
    (run_t, dir_t), (run_j, dir_j) = scene_runs["torch"], scene_runs["jax"]
    pt, pj = run_t.ba_pipeline, run_j.ba_pipeline
    for sub in ("masks", "features", "pairwise_matches"):
        ft = sorted(glob.glob(os.path.join(dir_t, "matches", sub, "*.npy")))
        fj = sorted(glob.glob(os.path.join(dir_j, "matches", sub, "*.npy")))
        assert [os.path.basename(f) for f in ft] == [os.path.basename(f) for f in fj], sub
        assert len(ft) == (N_CAM * (N_CAM - 1) // 2 if sub == "pairwise_matches" else N_CAM)
        for a, b in zip(ft, fj):
            np.testing.assert_array_equal(np.load(a), np.load(b))
    np.testing.assert_array_equal(pt.C, pj.C)
    assert len(pt.images) == N_CAM
    for it, ij in zip(pt.images, pj.images):
        assert it.alt == ij.alt
        lon, lat = float(np.asarray(it.rpc.lon_offset)), float(np.asarray(it.rpc.lat_offset))
        assert abs(it.alt - float(scene["dem_value"](lon, lat)[0])) < 1e-6
        assert it.alt != default_altitude(it.rpc)  # the DEM's value, not the RPC offset
    assert float(np.mean(pt.ba_e)) < 0.5 * float(np.mean(pt.init_e))
    files_t, proj_t = _rpc_adj_projections(dir_t)
    files_j, proj_j = _rpc_adj_projections(dir_j)
    assert [os.path.basename(f) for f in files_t] == [os.path.basename(f) for f in files_j]
    assert len(files_t) == N_CAM
    gap = max(float(np.abs(a - b).max()) for a, b in zip(proj_t, proj_j))
    print("rpc_adj gap to JAX: {:.3g} px".format(gap))
    assert gap < 1e-2, gap
