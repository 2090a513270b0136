"""Parity of the port's tracks front end with the JAX package's, from images
to tracks, on the CPU (where both match pairs with match_descriptors_2nn,
the symmetric epipolar gate; the card's staged int8 path is held against
JAX's in tests/test_torch_match.py).

The scene: four 300x400 views of a rendered ground texture at altitude 0,
below the synthetic cameras' altitude offset, so that the views differ by
an altitude parallax of up to ~40 px; written as uint8 TIFFs that both
pipelines read.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from sat_bundleadjust_tpu.models.cameras import SatelliteImage as JImage
from sat_bundleadjust_tpu.tracks import matching as jmatching
from sat_bundleadjust_tpu.tracks.pipeline import FeatureTracksPipeline as JPipeline
from sat_bundleadjust_tpu.utils.demo import render_synthetic_images as jrender

from sat_bundleadjust_tpu_torch.models.cameras import SatelliteImage as TImage
from sat_bundleadjust_tpu_torch.tracks import build as tbuild
from sat_bundleadjust_tpu_torch.tracks import matching as tmatching
from sat_bundleadjust_tpu_torch.tracks.pipeline import FeatureTracksPipeline as TPipeline
from sat_bundleadjust_tpu_torch.utils.demo import render_synthetic_images as trender

torch.set_num_threads(1)
H, W, N_CAM, ALT = 300, 400, 4, 0.0
CONFIG = {"FT_kp_max": 2000, "FT_save": False, "FT_reset": True}


def _images(cls, paths, rpcs):
    out = []
    for p, r in zip(paths, rpcs):
        im = cls(p, r, offset={"col0": 0, "row0": 0, "height": H, "width": W})
        im.set_footprint(alt=50.0)
        im.set_camera_center()
        out.append(im)
    return out


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracks_scene")
    ims, rpcs = jrender(n_cam=N_CAM, h=H, w=W, seed=0, alt=ALT)
    paths = []
    for k, im in enumerate(ims):
        p = os.path.join(str(root), "im{}.tif".format(k))
        Image.fromarray((im * 255).astype(np.uint8)).save(p)
        paths.append(p)
    out = os.path.join(str(root), "jax")
    jft = JPipeline(out, out, {"images": _images(JImage, paths, rpcs), "n_adj": 0, "aoi": None},
                    tracks_config=dict(CONFIG))
    bundle, _ = jft.build_feature_tracks()
    return {"root": str(root), "paths": paths, "rpcs": rpcs, "ims": ims, "jft": jft,
            "bundle": bundle}


def test_render_matches_jax(scene):
    """utils/demo.render_synthetic_images with the localization in torch:
    the views agree with JAX's to 1e-6 (float32 texture values; the
    float64 localizations differ in their last bits only)."""
    ims, _ = trender(n_cam=N_CAM, h=H, w=W, seed=0, alt=ALT, device="cpu")
    for a, b in zip(ims, scene["ims"]):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert np.abs(scene["ims"][0] - scene["ims"][1]).mean() > 0.01  # the views differ


def test_match_stereo_pairs_and_tracks_identical(scene):
    """match_stereo_pairs and the track build, fed JAX's features, UTM
    coordinates, footprints and F: identical pairwise_matches, C and C_v2."""
    jft, bundle = scene["jft"], scene["bundle"]
    F = jmatching.init_F_pairs_batched(jft.pairs_to_match, jft.images)
    cfg = dict(jft.config)
    timing = {}
    pm = tmatching.match_stereo_pairs(jft.pairs_to_match, jft.features, jft.footprints,
                                      jft.features_utm, cfg, F, device="cpu", timing=timing)
    assert pm.shape[0] > 1000
    np.testing.assert_array_equal(pm, bundle["pairwise_matches"])
    C, C_v2 = tbuild.feature_tracks_from_pairwise_matches(jft.features, pm,
                                                          jft.pairs_to_triangulate)
    np.testing.assert_array_equal(C, bundle["C"])
    np.testing.assert_array_equal(C_v2, bundle["C_v2"])
    assert {"prep_s", "nn_s", "finalize_s", "ransac_s", "assemble_s"} <= set(timing)


def test_epipolar_init_and_utm_coords(scene):
    """init_F_pairs_batched runs the same numpy code as JAX's: equal F.
    keypoints_to_utm_coords localizes with the numpy twin, JAX with its
    XLA localization: equal to 1e-6 m."""
    jft = scene["jft"]
    timgs = _images(TImage, scene["paths"], scene["rpcs"])
    Fj = jmatching.init_F_pairs_batched(jft.pairs_to_match, jft.images)
    Ft = tmatching.init_F_pairs_batched(jft.pairs_to_match, timgs)
    np.testing.assert_array_equal(np.stack(Ft), np.stack(Fj))
    f = jft.features[1]
    utm_j = jmatching.keypoints_to_utm_coords(f, jft.images[1].rpc, jft.images[1].offset, 50.0)
    utm_t = tmatching.keypoints_to_utm_coords(f, timgs[1].rpc, timgs[1].offset, 50.0)
    np.testing.assert_allclose(utm_t, utm_j, rtol=0, atol=1e-6)


def test_pipeline_from_images_to_tracks(scene):
    """FeatureTracksPipeline from the same images to tracks: the same pairs,
    keypoint counts within 1% and a track count within 2% of JAX's."""
    out = os.path.join(scene["root"], "torch")
    ft = TPipeline(out, out, {"images": _images(TImage, scene["paths"], scene["rpcs"]),
                              "n_adj": 0, "aoi": None},
                   tracks_config=dict(CONFIG), device="cpu")
    bundle, _ = ft.build_feature_tracks()
    want = scene["bundle"]
    assert bundle["pairs_to_match"] == want["pairs_to_match"]
    assert bundle["pairs_to_triangulate"] == want["pairs_to_triangulate"]
    for a, b in zip(bundle["features"], want["features"]):
        na, nb = np.sum(~np.isnan(a[:, 0])), np.sum(~np.isnan(b[:, 0]))
        assert abs(na - nb) <= 0.01 * nb
    n_t, n_j = bundle["C"].shape[1], want["C"].shape[1]
    assert n_j > 300
    assert abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
    assert {"detection_s", "pairs_s", "F_init_s", "nn_s", "finalize_s", "tracks_s"} <= set(ft.timing)
    assert not os.path.exists(os.path.join(out, "features"))  # the in-memory handoff


def test_union_find_native_and_fallback():
    """The committed native union-find and the Python fallback give the same
    partition."""
    rng = np.random.RandomState(0)
    ea = rng.randint(0, 500, 800).astype(np.int64)
    eb = rng.randint(0, 500, 800).astype(np.int64)
    assert tbuild._load_native() is not None
    native = tbuild.union_find(500, ea, eb)
    saved = tbuild._NATIVE_LIB, tbuild._NATIVE_TRIED
    tbuild._NATIVE_LIB, tbuild._NATIVE_TRIED = None, True
    try:
        py = tbuild.union_find(500, ea, eb)
    finally:
        tbuild._NATIVE_LIB, tbuild._NATIVE_TRIED = saved
    lab_n = {r: i for i, r in enumerate(dict.fromkeys(native.tolist()))}
    lab_p = {r: i for i, r in enumerate(dict.fromkeys(py.tolist()))}
    assert [lab_n[r] for r in native.tolist()] == [lab_p[r] for r in py.tolist()]


def test_feature_tracks_from_matches():
    """3 cameras, one 3-view track and two 2-view tracks."""
    feats = [np.zeros((10, 132)) for _ in range(3)]
    for c in range(3):
        feats[c][:, 0] = np.arange(10) + 100 * c
        feats[c][:, 1] = np.arange(10) * 2
    matches = np.array([[0, 1, 0, 1], [1, 2, 1, 2], [5, 5, 0, 1], [7, 8, 1, 2]])
    C, C_v2 = tbuild.feature_tracks_from_pairwise_matches(feats, matches, [(0, 1), (1, 2), (0, 2)])
    assert C.shape == (6, 3)
    lens = np.sum(~np.isnan(C[::2]), axis=0)
    assert sorted(lens.tolist()) == [2, 2, 3]
    t3 = int(np.argmax(lens))
    assert C[0, t3] == 0.0 and C[2, t3] == 101.0 and C[4, t3] == 202.0
    assert C_v2[0, t3] == 0 and C_v2[1, t3] == 1 and C_v2[2, t3] == 2
