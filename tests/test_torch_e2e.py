"""The end-to-end gate of the port: tests/test_e2e.py's rendered scene run
through `sat_bundleadjust_tpu.main` and `sat_bundleadjust_tpu_torch.main`
(device="cpu") with the same config, then compared.

The scene: four 300x400 views of a ground texture at the cameras' altitude
offset, RPC biases of up to +-4 px on cameras 1-3 (tests/test_e2e.py:60-99);
the config is test_e2e.py's (bruteforce matching, FT_kp_max 3000,
save_figures False) with FT_save at its default, True. The port's run must
pass test_e2e.py's thresholds, and against the JAX run:
- the .rpc_adj files project a ground grid within 1e-2 px (measured on
  this scene: 2.6e-5 px);
- cam_params/ agree within 1e-6 rad, the LM tolerance of
  tests/test_torch_slice.py (measured: 7.2e-8 rad);
- pts3d_adj.ply holds as many points, and the two sets lie within 1e-6
  rad x the largest camera distance of each other (measured: 6.6e-3 m).
  Index by index all but 0.5% of the points agree to that tolerance: the
  scale sort of the keypoints puts two keypoints whose scales differ by
  3e-6 (tests/test_torch_sift.py's SIFT tolerance) in the other order, and
  their tracks with them (2 of 3000 points here);
- the FT_save caches (features/, features_utm/, pairwise_matches/) hold
  the same file names.
A second run over a copy of the port's output directory, with reset False,
reads those caches back (detection and 2-NN matching are made to fail if
called) and gives the same tracks.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from test_e2e import TERRAIN_ALT, render_image, world_texture

CONFIG = {
    "rpc_src": "txt",
    "cam_model": "rpc",
    "ba_method": "ba_bruteforce",
    "FT_kp_max": 3000,
    "FT_sift_detection": "tpu",
    "FT_sift_matching": "bruteforce",
    "clean_outliers": True,
    "save_figures": False,
}
GRID_LON = -72.71 + np.linspace(-0.01, 0.01, 9)
GRID_LAT = 11.02 + np.linspace(-0.01, 0.01, 9)


def _write_config(root, name, img_dir, **extra):
    cfg = dict(CONFIG, geotiff_dir=img_dir, rpc_dir=img_dir,
               output_dir=os.path.join(root, "out_" + name), **extra)
    path = os.path.join(root, "config_{}.json".format(name))
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, os.path.join(cfg["output_dir"], "ba_bruteforce")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import sat_bundleadjust_tpu
    from sat_bundleadjust_tpu.models.rpc import write_rpc_file
    from sat_bundleadjust_tpu.utils.demo import make_synthetic_rpc

    import sat_bundleadjust_tpu_torch
    from sat_bundleadjust_tpu_torch.ops import match as tmatch
    from sat_bundleadjust_tpu_torch.ops import sift as tsift

    root = str(tmp_path_factory.mktemp("torch_e2e"))
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    tex = world_texture()
    h, w = 300, 400
    rng = np.random.RandomState(7)
    true_rpcs, biased_rpcs = [], []
    for i in range(4):
        rpc = make_synthetic_rpc(view_dx=250.0 * np.cos(2 * np.pi * i / 4),
                                 view_dy=250.0 * np.sin(2 * np.pi * i / 4), img_halfsize=(w / 2, h / 2))
        bias = np.zeros(2) if i == 0 else rng.uniform(-4, 4, 2)
        biased = rpc._replace(col_offset=rpc.col_offset + bias[0], row_offset=rpc.row_offset + bias[1])
        true_rpcs.append(rpc)
        biased_rpcs.append(biased)
        name = "2020041{}_1514{:02d}_synth_cam{}".format(3, 10 + i, i)
        Image.fromarray(render_image(rpc, tex, h, w)).save(os.path.join(img_dir, name + ".tif"))
        write_rpc_file(biased, os.path.join(img_dir, name + ".rpc"))

    cfg_j, out_j = _write_config(root, "jax", img_dir)
    cfg_t, out_t = _write_config(root, "torch", img_dir)
    scene_j = sat_bundleadjust_tpu.main(cfg_j)

    def refuse(*args, **kwargs):
        raise AssertionError("the second run must read the caches")

    scene_t = sat_bundleadjust_tpu_torch.main(cfg_t, device="cpu")
    # the second run reads the caches of a copy of the first run's output
    cfg_2, out_2 = _write_config(root, "torch2", img_dir, reset=False)
    shutil.copytree(os.path.dirname(out_t), os.path.dirname(out_2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsift, "detect_sift_batch", refuse)
        mp.setattr(tmatch, "match_pairs_2nn_batched", refuse)
        scene_2 = sat_bundleadjust_tpu_torch.main(cfg_2, device="cpu")
    return {"jax": scene_j, "torch": scene_t, "second": scene_2, "out_jax": out_j,
            "out_torch": out_t, "true_rpcs": true_rpcs, "biased_rpcs": biased_rpcs}


def _projections(rpcs):
    from sat_bundleadjust_tpu_torch.models.rpc import rpc_projection_np

    LO, LA = np.meshgrid(GRID_LON, GRID_LAT)
    alts = np.full(LO.size, TERRAIN_ALT)
    return [np.stack(rpc_projection_np(r, LO.ravel(), LA.ravel(), alts), axis=1) for r in rpcs]


def _rpc_adj(out_dir):
    from sat_bundleadjust_tpu_torch.models.rpc import rpc_from_rpc_file

    files = sorted(glob.glob(os.path.join(out_dir, "rpcs_adj", "*.rpc_adj")))
    return files, [rpc_from_rpc_file(f) for f in files]


def test_port_run_meets_e2e_thresholds(runs):
    """tests/test_e2e.py's thresholds on the port's run."""
    files, adj = _rpc_adj(runs["out_torch"])
    assert len(files) == 4
    pipe = runs["torch"].ba_pipeline
    ba_e, init_e = float(np.mean(pipe.ba_e)), float(np.mean(pipe.init_e))
    assert init_e > 1.0, init_e
    assert ba_e < 0.5 * init_e, (init_e, ba_e)
    assert ba_e < 1.0, ba_e

    truth = _projections(runs["true_rpcs"])

    def consistency(rpcs):
        return np.mean([np.linalg.norm(p - q, axis=1) for p, q in zip(_projections(rpcs), truth)])

    err_biased, err_adj = consistency(runs["biased_rpcs"]), consistency(adj)
    assert err_adj < 0.7 * err_biased, (err_biased, err_adj)


def test_rpc_adj_and_cam_params_match_jax(runs):
    fj, rj = _rpc_adj(runs["out_jax"])
    ft, rt = _rpc_adj(runs["out_torch"])
    assert [os.path.basename(f) for f in fj] == [os.path.basename(f) for f in ft]
    gap = max(float(np.abs(a - b).max()) for a, b in zip(_projections(rj), _projections(rt)))
    assert gap < 1e-2, gap

    def params(out_dir):
        out = {}
        for f in sorted(glob.glob(os.path.join(out_dir, "cam_params", "*.params"))):
            with open(f) as fh:
                lines = fh.read().split("\n")
            out[os.path.basename(f)] = {lines[k]: np.array([float(v) for v in lines[k + 1].split()])
                                        for k in range(0, len(lines) - 1, 2)}
        return out

    pj, pt = params(runs["out_jax"]), params(runs["out_torch"])
    assert sorted(pj) == sorted(pt) and len(pj) == 4
    for name in pj:
        assert sorted(pj[name]) == sorted(pt[name]) == ["C", "R"]
        np.testing.assert_allclose(pt[name]["R"], pj[name]["R"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(pt[name]["C"], pj[name]["C"])


def test_points_match_jax(runs):
    from scipy.spatial import cKDTree

    from sat_bundleadjust_tpu_torch.utils.io import read_point_cloud_ply

    pj = read_point_cloud_ply(os.path.join(runs["out_jax"], "pts3d_adj.ply"))
    pt = read_point_cloud_ply(os.path.join(runs["out_torch"], "pts3d_adj.ply"))
    assert pj.shape == pt.shape and np.all(np.isfinite(pt))
    centers = np.array([im.center for im in runs["torch"].ba_pipeline.images])
    tol = 1e-6 * float(np.max(np.linalg.norm(pt[:, None, :] - centers[None], axis=-1)))
    # as sets (Hausdorff distance: SIFT's duplicate keypoints at one place
    # make near-duplicate points, so nearest neighbours are not one-to-one)
    d_tj = cKDTree(pj).query(pt)[0]
    d_jt = cKDTree(pt).query(pj)[0]
    assert max(d_tj.max(), d_jt.max()) < tol, (d_tj.max(), d_jt.max(), tol)
    # index by index, all but the swapped tracks (2 of 3000 here)
    moved = np.linalg.norm(pt - pj, axis=1) >= tol
    assert moved.sum() <= 0.005 * len(pt), moved.sum()


def test_tracks_caches_and_second_run(runs):
    """The FT_save caches hold the JAX run's file names; the second run
    read them and built the same tracks as the first."""
    def names(out_dir):
        return sorted(os.path.relpath(p, out_dir) for p in glob.glob(
            os.path.join(out_dir, "matches", "*", "*.npy")))

    nj, nt = names(runs["out_jax"]), names(runs["out_torch"])
    assert nj == nt
    for sub, n in (("features", 4), ("features_utm", 4), ("pairwise_matches", 6)):
        assert sum(x.startswith(os.path.join("matches", sub) + os.sep) for x in nt) == n, sub

    first, second = runs["torch"].ba_pipeline, runs["second"].ba_pipeline
    assert np.array_equal(first.C, second.C, equal_nan=True)
    assert np.array_equal(first.C_v2, second.C_v2, equal_nan=True)
    assert first.pairs_to_triangulate == second.pairs_to_triangulate
    np.testing.assert_array_equal(second.ba_params.pts3d_ba, first.ba_params.pts3d_ba)


def test_debug_figures_same_names(runs):
    """save_feature_tracks and save_debug_figures (what save_figures adds to
    a run) write the JAX package's file names."""
    for key in ("jax", "torch"):
        pipe = runs[key].ba_pipeline
        pipe.save_feature_tracks()
        pipe.save_debug_figures()

    def names(out_dir):
        return sorted(os.path.relpath(p, out_dir)
                      for p in glob.glob(os.path.join(out_dir, "ba_figures", "**", "*"), recursive=True)
                      if os.path.isfile(p))

    nj, nt = names(runs["out_jax"]), names(runs["out_torch"])
    assert nt == nj and len(nt) == 9, nt
    assert all(os.path.getsize(os.path.join(runs["out_torch"], n)) > 0 for n in nt)
