"""Parity of the port's orchestration with the JAX package's: the camera
connectivity checks, track ranking and selection, the scene driver
(dates, the three rpc_src values), the environment knobs
SATBA_CG_COARSE_K and SATBA_TRIANG_CHUNK, and the options that cannot
run, which must raise before any track or solve instead of running
another route.
"""

import datetime
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_common import both_problems, jax_scene

from sat_bundleadjust_tpu import timeseries as jts
from sat_bundleadjust_tpu.ba import solver as jsolver
from sat_bundleadjust_tpu.models import rpc as jrpc
from sat_bundleadjust_tpu.ops import triangulate as jtri
from sat_bundleadjust_tpu.tracks import build as jbuild
from sat_bundleadjust_tpu.tracks import ranking as jrank
from sat_bundleadjust_tpu.utils import tiffwrite as jtiffwrite
from sat_bundleadjust_tpu.utils.demo import make_synthetic_rpc

import sat_bundleadjust_tpu_torch
from sat_bundleadjust_tpu_torch import cli as tcli
from sat_bundleadjust_tpu_torch import timeseries as tts
from sat_bundleadjust_tpu_torch.ba import solver as tsolver
from sat_bundleadjust_tpu_torch.ops import triangulate as ttri
from sat_bundleadjust_tpu_torch.tracks import build as tbuild
from sat_bundleadjust_tpu_torch.tracks import ranking as trank
from sat_bundleadjust_tpu_torch.utils.dem import make_alt_getter


def _C_two_components(seed=0):
    """C (2M, N) of 7 cameras: cameras 0-3 share tracks, cameras 4-5 share
    tracks only with each other, camera 6 sees 4 tracks alone."""
    rng = np.random.RandomState(seed)
    n_pts = 300
    C = np.full((14, n_pts), np.nan)
    for k in range(n_pts):
        if k < 200:
            cams = rng.choice(4, rng.randint(2, 5), replace=False)
        elif k < 296:
            cams = np.array([4, 5])
        else:
            cams = np.array([6])
        for c in cams:
            C[2 * c: 2 * c + 2, k] = rng.uniform(0, 1000, 2)
    return C


def test_connectivity_checks_match_jax(capsys):
    C = _C_two_components()
    for mm in (0, 5, 10, 60):
        np.testing.assert_array_equal(tbuild.build_connectivity_matrix(C, mm),
                                      jbuild.build_connectivity_matrix(C, mm))
    n_cc = {}
    for mm in (0, 5, 100):
        capsys.readouterr()
        _, ej, wj, nj, mj = jbuild.build_connectivity_graph(C, mm, verbose=True)
        out_j = capsys.readouterr().out
        G, et, wt, nt, mt = tbuild.build_connectivity_graph(C, mm, verbose=True)
        out_t = capsys.readouterr().out
        assert (et, wt, nt) == (ej, wj, nj) and sorted(mt) == sorted(mj)
        assert out_t == out_j
        assert len(G["components"]) == nt and sorted(sum(G["components"], [])) == list(range(7))
        n_cc[mm] = nt
    assert n_cc[5] == 3 and mt == [4, 5, 6]
    for args in ((C, 10), (C, 3), (C[:, :5], 10), (None, 10)):
        assert tbuild.check_correspondence_matrix(*args) == jbuild.check_correspondence_matrix(*args)
    pairs_m = [(0, 1), (1, 2), (2, 3), (4, 5)]
    pairs_t = [(0, 1), (4, 5)]
    for cams in (range(7), range(2, 7), range(4)):
        capsys.readouterr()
        rj = jbuild.check_pairs(cams, pairs_m, pairs_t)
        out_j = capsys.readouterr().out
        rt = tbuild.check_pairs(cams, pairs_m, pairs_t)
        assert rt == rj and capsys.readouterr().out == out_j
    assert tbuild.check_pairs(range(7), pairs_m, pairs_t)[2] == [2, 3, 6]


def test_print_quick_camera_weights_same_text(capsys):
    C = _C_two_components(1)
    paths = ["/scene/{:02d}_d{}_img.tif".format(k, 1 + k % 3) for k in range(7)]
    capsys.readouterr()
    jrank.print_quick_camera_weights(paths, C)
    out_j = capsys.readouterr().out
    trank.print_quick_camera_weights(paths, C)
    assert capsys.readouterr().out == out_j and "cam   6" in out_j


@pytest.fixture(scope="module")
def ranking_inputs():
    """A 6-camera demo scene's C with keypoint ids, features and the
    reprojection errors at the initial parameters, from both packages."""
    scene = jax_scene(n_cam=6, n_pts=400, seed=4)
    jp, tp = both_problems(scene, dense_c=True)
    rng = np.random.RandomState(4)
    C = jp.C
    C_v2 = np.where(np.isnan(C[::2]), np.nan, np.arange(C.shape[1])[None, :].astype(float))
    features = [np.concatenate([rng.uniform(0, 100, (C.shape[1], 2)),
                                np.round(rng.uniform(1, 4, (C.shape[1], 1)), 1),
                                rng.uniform(0, 1, (C.shape[1], 129))], axis=1) for _ in range(6)]
    args = (C, jp.pts3d, jp.cameras, "rpc", jp.pairs_to_triangulate, jp.camera_centers)
    Rj = jrank.compute_C_reproj(*args)
    Rt = trank.compute_C_reproj(C, tp.pts3d, tp.cameras, "rpc", tp.pairs_to_triangulate,
                                tp.camera_centers, device="cpu")
    return {"C": C, "C_v2": C_v2, "features": features, "Rj": Rj, "Rt": Rt}


def test_ranking_inputs_match_jax(ranking_inputs):
    r = ranking_inputs
    Sj = jrank.compute_C_scale(r["C_v2"], r["features"])
    St = trank.compute_C_scale(r["C_v2"], r["features"])
    np.testing.assert_array_equal(St, Sj)
    # residuals of the same f64 chain in other summation orders (the
    # RPC-polynomial tolerance of tests/test_torch_jacobians.py)
    assert np.array_equal(np.isnan(r["Rt"]), np.isnan(r["Rj"]))
    np.testing.assert_allclose(r["Rt"], r["Rj"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(trank.compute_camera_weights(r["C"], r["Rt"]),
                               jrank.compute_camera_weights(r["C"], r["Rt"]), rtol=1e-12)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("priority", [("length", "scale", "cost"), ("cost", "length", "scale")])
def test_select_best_tracks_matches_jax(ranking_inputs, K, priority):
    """FT_K > 0: the same ranking and the same selected tracks, plain and
    sensor-aware (images named d1_/d2_/d3_), on the same inputs."""
    r = ranking_inputs
    S = jrank.compute_C_scale(r["C_v2"], r["features"])
    assert trank.order_tracks(r["C"], S, r["Rj"], priority) == jrank.order_tracks(r["C"], S, r["Rj"], priority)
    sj = jrank.select_best_tracks(r["C"], S, r["Rj"], K, priority)
    st = trank.select_best_tracks(r["C"], S, r["Rj"], K, priority)
    np.testing.assert_array_equal(st, sj)
    assert 0 < len(st) < r["C"].shape[1]

    class Im:
        def __init__(self, k):
            self.geotiff_path = "/s/{}_d{}_x.tif".format(k, 1 + k // 2)

    ims = [Im(k) for k in range(6)]
    np.testing.assert_array_equal(
        trank.select_best_tracks_sensor_aware(ims, r["C"], S, r["Rj"], K, priority),
        jrank.select_best_tracks_sensor_aware(ims, r["C"], S, r["Rj"], K, priority))


def test_coarse_k_knob_matches_jax(monkeypatch):
    """SATBA_CG_COARSE_K=4 reaches the port's CG as it reaches JAX's: the
    same coarse cluster count, and a 16-camera CG solve within the 1e-3 px
    and 2-iteration bars of tests/test_torch_solver.py."""
    monkeypatch.setenv("SATBA_CG_COARSE_K", "4")
    jp, tp = both_problems(jax_scene(n_cam=16, n_pts=1000, seed=0))
    solver = tsolver.BASolver(tp, schur_mode="cg", device="cpu")
    assert solver.config().cg_coarse_k == 4
    ls = {"max_iter": 50}
    _, _, je0, je1, jit = jsolver.run_ba_optimization(jp, ls, schur_mode="cg")
    _, _, te0, te1, tit = tsolver.run_ba_optimization(tp, ls, solver=solver)
    assert te1.mean() < 0.2 * te0.mean()
    assert abs(float(te1.mean()) - float(je1.mean())) <= 1e-3
    assert abs(tit - jit) <= 2
    monkeypatch.delenv("SATBA_CG_COARSE_K")
    assert solver.config().cg_coarse_k == 1


def test_triangulation_chunk_knob_matches_jax(monkeypatch):
    """SATBA_TRIANG_CHUNK=37 splits the duos into chunks of 37 in both
    packages: within 1e-4 m of JAX (the tolerance of
    tests/test_torch_slice.py) and identical to the port's one-chunk run."""
    scene = jax_scene(n_cam=5, n_pts=120, seed=12)
    jp, tp = both_problems(scene, dense_c=True)
    whole = ttri.init_pts3d(jp.C, tp.cameras, "rpc", tp.pairs_to_triangulate, device="cpu")
    monkeypatch.setenv("SATBA_TRIANG_CHUNK", "37")
    pj = jtri.init_pts3d(jp.C, jp.cameras, "rpc", jp.pairs_to_triangulate)
    pt = ttri.init_pts3d(jp.C, tp.cameras, "rpc", tp.pairs_to_triangulate, device="cpu")
    pts, cam = torch.as_tensor(tp.pts_ind).long(), torch.as_tensor(tp.cam_ind).long()
    duos, _ = ttri.observation_duos(pts, cam, tp.n_pts, tp.n_cam,
                                    ttri.pair_lookup(tp.pairs_to_triangulate, tp.n_cam, "cpu"))
    assert duos.numel() > 37 * 3
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(pt, whole)


# ----------------------------------------------------------------------
# the scene driver
# ----------------------------------------------------------------------


def _scene_dir(root, src, n=3):
    """n rpc-only (txt, json) or geotiff (RPC tag) images of two dates."""
    img_dir = os.path.join(root, "images_" + src)
    os.makedirs(img_dir)
    stamps = ["20200413_151410", "20200413_152000", "20200414_093000"]
    for k in range(n):
        rpc = make_synthetic_rpc(view_dx=200.0 * np.cos(k), view_dy=200.0 * np.sin(k),
                                 img_halfsize=(200, 150))
        name = "{}_cam{}".format(stamps[k], k)
        if src == "txt":
            jrpc.write_rpc_file(rpc, os.path.join(img_dir, name + ".rpc"))
        elif src == "json":
            Image.fromarray(np.zeros((300, 400), np.uint8)).save(os.path.join(img_dir, name + ".tif"))
            jrpc.write_rpc_json(rpc, os.path.join(img_dir, name + ".json"))
        else:
            path = os.path.join(img_dir, name + ".tif")
            Image.fromarray(np.zeros((300, 400), np.uint8)).save(path)
            jtiffwrite.update_geotiff_rpc(path, rpc)
    return img_dir


def _config(root, img_dir, src, name, **extra):
    cfg = dict({"geotiff_dir": img_dir, "rpc_dir": img_dir, "rpc_src": src,
                "output_dir": os.path.join(root, "out_" + name)}, **extra)
    path = os.path.join(root, name + ".json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.mark.parametrize("src", ["txt", "json", "geotiff"])
def test_scene_loads_like_jax(tmp_path, src):
    """The same timeline and byte-identical rpcs_init/ files, for each
    rpc_src."""
    img_dir = _scene_dir(str(tmp_path), src)
    sj = jts.Scene(_config(str(tmp_path), img_dir, src, "jax"))
    st = tts.Scene(_config(str(tmp_path), img_dir, src, "torch"), device="cpu")
    strip = lambda tl: [{k: v for k, v in d.items()} for d in tl]  # noqa: E731
    assert strip(st.timeline) == strip(sj.timeline) and len(st.timeline) == 2
    assert st.tracks_config == sj.tracks_config
    names = sorted(os.listdir(os.path.join(sj.dst_dir, "rpcs_init")))
    assert names == sorted(os.listdir(os.path.join(st.dst_dir, "rpcs_init"))) and len(names) == 3
    for n in names:
        with open(os.path.join(sj.dst_dir, "rpcs_init", n), "rb") as a, \
                open(os.path.join(st.dst_dir, "rpcs_init", n), "rb") as b:
            assert a.read() == b.read()


def test_acquisition_dates_match_jax():
    rng = np.random.RandomState(0)
    base = datetime.datetime(2020, 4, 13, 15, 0, 0)
    dts = [base + datetime.timedelta(minutes=float(m)) for m in np.sort(rng.uniform(0, 600, 40))]
    order = rng.permutation(40)
    dts = [dts[i] for i in order]
    names = ["im{}".format(i) for i in range(40)]
    for margin in (5.0, 30.0, 120.0):
        assert tts.group_files_by_date(dts, names, margin) == jts.group_files_by_date(dts, names, margin)
    assert tts.get_acquisition_date("/x/20200413_151410_a.tif") == jts.get_acquisition_date(
        "/x/20200413_151410_a.tif")


def _run(tmp_path, **extra):
    img_dir = _scene_dir(str(tmp_path), "txt")
    cfg = _config(str(tmp_path), img_dir, "txt", "torch", **extra)
    return sat_bundleadjust_tpu_torch.main(cfg, device="cpu")


# the ids are the names these cases had while each option raised
# NotImplementedError naming its ROADMAP item
UNPORTED_IDS = ["extra0-FT_sift_detection.*Queue 1 item 10", "extra1-lightglue.*Queue 1 item 10",
                "extra2-distributed.*Queue 1 item 12", "extra3-dem_path.*Queue 1 item 13",
                "extra4-local_window.*Queue 1 item 10", "extra5-FT_kp_aoi.*Queue 1 item 10",
                "extra6-lightglue.*Queue 1 item 10"]


@pytest.mark.parametrize("extra, error, match", [
    ({"FT_sift_detection": "opencv"}, AssertionError, "another route ran"),
    ({"FT_sift_matching": "lightglue"}, ImportError, "LightGlue package"),
    ({"distributed": True}, AssertionError, "another route ran"),
    ({"dem_path": "/nonexistent/dem.tif"}, FileNotFoundError, "dem.tif"),
    ({"FT_sift_matching": "local_window"}, NotImplementedError, "imscript siftu binary"),
    ({"FT_kp_aoi": True, "aoi_geojson": "AOI"}, AssertionError, "another route ran"),
    ({"ba_method": "ba_sequential", "FT_sift_matching": "lightglue"}, ImportError,
     "LightGlue package"),
], ids=UNPORTED_IDS)
def test_unported_options_raise(tmp_path, monkeypatch, extra, error, match):
    """The options that cannot run raise before any track or solve runs
    (also in the sequential mode): local_window, which the JAX package does
    not run either (its NotImplementedError); lightglue without its package
    (the JAX package's ImportError); a DEM that is not there. The options
    ported since (opencv, FT_kp_aoi with an AOI, the multi-device solve)
    set up and reach the tracks front end, stubbed here to raise."""
    from sat_bundleadjust_tpu_torch.parallel import mesh as tmesh
    from sat_bundleadjust_tpu_torch.tracks import pipeline as tpipe

    def refuse(*args, **kwargs):
        raise AssertionError("another route ran")

    monkeypatch.setattr(tpipe.FeatureTracksPipeline, "build_feature_tracks", refuse)
    monkeypatch.setitem(sys.modules, "lightglue", None)
    # "distributed" pins a process-wide default mesh: none after the test
    monkeypatch.setattr(tmesh, "_MESH_OVERRIDE", None)
    if extra.get("aoi_geojson") == "AOI":
        from sat_bundleadjust_tpu_torch.utils.geo import geojson_polygon
        from sat_bundleadjust_tpu_torch.utils.io import save_geojson

        extra = dict(extra, aoi_geojson=str(tmp_path / "aoi.json"))
        save_geojson(extra["aoi_geojson"], geojson_polygon(np.array(
            [[-72.72, 11.01], [-72.70, 11.01], [-72.70, 11.03], [-72.72, 11.03]])))
    with pytest.raises(error, match=match):
        _run(tmp_path, **extra)
    if extra.get("distributed"):
        # the knob set up a mesh of this one process for every stage
        assert tmesh.get_default_mesh().size == 1
    if extra.get("FT_kp_aoi"):
        # the AOI masks are written when the tracks front end is set up
        assert glob.glob(str(tmp_path / "**" / "masks" / "*.npy"), recursive=True)
    assert make_alt_getter(None) is None


def test_entry_points_need_the_card_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    img_dir = _scene_dir(str(tmp_path), "txt")
    cfg = _config(str(tmp_path), img_dir, "txt", "torch")
    from sat_bundleadjust_tpu_torch.pipeline import BundleAdjustmentPipeline

    for call in (lambda: sat_bundleadjust_tpu_torch.main(cfg), lambda: tcli.main([cfg, "--verbose"]),
                 lambda: tcli.main([cfg, "--timeline"]), lambda: tts.Scene(cfg),
                 lambda: BundleAdjustmentPipeline({"in_dir": "", "out_dir": str(tmp_path / "o"),
                                                   "images": []})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    scene = tts.Scene(cfg, device="cpu")
    assert scene.device == torch.device("cpu") and len(scene.timeline) == 2


@pytest.mark.parametrize("missing", ["matplotlib", "scipy.spatial"])
def test_figures_name_save_figures_when_a_module_is_missing(tmp_path, monkeypatch, missing):
    """A figure whose module cannot be imported raises an error that names
    save_figures; it is never skipped."""
    from sat_bundleadjust_tpu_torch.utils import viz

    real = viz.importlib.import_module

    def fake(name, *args):
        if name == missing:
            raise ImportError("no module named " + name)
        return real(name, *args)

    monkeypatch.setattr(viz.importlib, "import_module", fake)
    with pytest.raises(ImportError, match="save_figures"):
        if missing == "matplotlib":
            viz.save_histogram_of_errors(str(tmp_path / "h.png"), np.ones(5), np.ones(5))
        else:
            viz.idw_interpolation(np.zeros((3, 2)), np.ones(3), np.zeros((1, 2)))
