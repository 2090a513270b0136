"""Predefined-matches bundles across both packages (tracks/predefined.py,
utils/io.save_predefined_matches, the pipeline's predefined_matches
branch), on the CPU (device="cpu").

Three rendered 140x180 views (tests/test_predefined_matches.py's
renderer). Each package's pipeline builds its tracks with FT_save and
writes a bundle with its own save_predefined_matches; each bundle is then
read by both packages' pipelines with predefined_matches: the same C
(NaN where unobserved, bit for bit), C_v2, pairs and fixed-track count,
and the same FT_save artifacts; the port's solve on a bundle gives
.rpc_adj files within 1e-2 px of the JAX run's on a ground grid (the bar
of tests/test_torch_e2e.py). The index helpers are held against JAX's on
edge cases: a target missing from the manifest, n_adj of 0, 1 and all.
"""

import os

import numpy as np
import pytest

from test_e2e import TERRAIN_ALT, render_image, world_texture

CFG = {"FT_kp_max": 600, "FT_sift_detection": "tpu", "FT_sift_matching": "bruteforce"}


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    from PIL import Image

    from sat_bundleadjust_tpu.models.cameras import SatelliteImage as JImage
    from sat_bundleadjust_tpu.models.rpc import rpc_from_rpc_file as jread
    from sat_bundleadjust_tpu.models.rpc import write_rpc_file
    from sat_bundleadjust_tpu.pipeline import BundleAdjustmentPipeline as JPipe
    from sat_bundleadjust_tpu.utils.demo import make_synthetic_rpc
    from sat_bundleadjust_tpu.utils.io import save_predefined_matches as jsave

    from sat_bundleadjust_tpu_torch.models.cameras import SatelliteImage as TImage
    from sat_bundleadjust_tpu_torch.models.rpc import rpc_from_rpc_file as tread
    from sat_bundleadjust_tpu_torch.pipeline import BundleAdjustmentPipeline as TPipe
    from sat_bundleadjust_tpu_torch.utils.io import save_predefined_matches as tsave

    root = tmp_path_factory.mktemp("torch_predefined")
    img_dir = root / "images"
    img_dir.mkdir()
    tex = world_texture()
    h, w = 140, 180
    rng = np.random.RandomState(3)
    paths = []
    for i in range(3):
        rpc = make_synthetic_rpc(view_dx=220.0 * np.cos(2.1 * i), view_dy=220.0 * np.sin(2.1 * i),
                                 img_halfsize=(w / 2, h / 2))
        bias = np.zeros(2) if i == 0 else rng.uniform(-2, 2, 2)
        name = "20200413_15150{}_synth_cam{}".format(i, i)
        Image.fromarray(render_image(rpc, tex, h, w)).save(str(img_dir / (name + ".tif")))
        write_rpc_file(rpc._replace(col_offset=rpc.col_offset + bias[0],
                                    row_offset=rpc.row_offset + bias[1]),
                       str(img_dir / (name + ".rpc")))
        paths.append(str(img_dir / (name + ".tif")))

    def images(pkg):
        cls, read = (JImage, jread) if pkg == "jax" else (TImage, tread)
        return [cls(p, read(p[:-4] + ".rpc")) for p in paths]

    def pipeline(pkg, in_dir, out_dir, **extra):
        extra = dict({"save_figures": False}, **extra)
        data = {"in_dir": in_dir, "out_dir": out_dir, "images": images(pkg)}
        if pkg == "jax":
            return JPipe(data, tracks_config=CFG, extra_ba_config=extra)
        return TPipe(data, tracks_config=CFG, extra_ba_config=extra, device="cpu")

    for pkg, save in (("jax", jsave), ("torch", tsave)):
        out = str(root / "tracks_{}".format(pkg))
        pipeline(pkg, out, out).compute_feature_tracks()
        save(os.path.join(out, "matches"), out)
    return {"root": str(root), "paths": paths, "pipeline": pipeline}


def _read(b, reader, writer, run=False):
    in_dir = os.path.join(b["root"], "tracks_{}".format(writer))
    out = os.path.join(b["root"], "read_{}_from_{}".format(reader, writer))
    p = b["pipeline"](reader, in_dir, out, predefined_matches=True)
    if run:
        p.run()
    else:
        p.compute_feature_tracks()
    return p, out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bundle_gives_the_same_tracks_in_both_packages(bundles, writer):
    """A bundle written by either package is read by both to the same
    tracks and the same FT_save artifacts."""
    pj, oj = _read(bundles, "jax", writer)
    pt, ot = _read(bundles, "torch", writer)
    assert pt.C.shape[1] > 20
    np.testing.assert_array_equal(pt.C, pj.C)
    np.testing.assert_array_equal(pt.C_v2, pj.C_v2)
    assert [tuple(map(int, q)) for q in pt.pairs_to_triangulate] == \
        [tuple(map(int, q)) for q in pj.pairs_to_triangulate]
    assert pt.n_pts_fix == pj.n_pts_fix
    for name in ("matches.npy", "pairs_matching.npy", "pairs_triangulation.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(ot, "matches", name)),
                                      np.load(os.path.join(oj, "matches", name)))
    with open(os.path.join(ot, "matches", "filenames.txt")) as a, \
            open(os.path.join(oj, "matches", "filenames.txt")) as b:
        assert a.read() == b.read()


def test_bundles_of_both_writers_are_identical(bundles):
    """save_predefined_matches of both packages over their own FT_save
    caches: the same manifest, match table and keypoint files."""
    from sat_bundleadjust_tpu_torch.utils.io import load_list_of_paths

    bj, bt = (os.path.join(bundles["root"], "tracks_" + k, "predefined_matches")
              for k in ("jax", "torch"))
    assert load_list_of_paths(os.path.join(bt, "filenames.txt")) == \
        load_list_of_paths(os.path.join(bj, "filenames.txt"))
    assert sorted(os.listdir(os.path.join(bt, "keypoints"))) == \
        sorted(os.listdir(os.path.join(bj, "keypoints")))
    mt, mj = (np.load(os.path.join(b, "matches.npy")) for b in (bt, bj))
    assert mt.shape == mj.shape and mt.shape[0] > 20


def test_solve_on_a_bundle_matches_jax(bundles):
    """The whole pipeline on the JAX-written bundle, both packages: .rpc_adj
    within 1e-2 px of each other on a ground grid."""
    from sat_bundleadjust_tpu_torch.models.rpc import rpc_from_rpc_file, rpc_projection_np

    _, oj = _read(bundles, "jax", "jax", run=True)
    _, ot = _read(bundles, "torch", "jax", run=True)
    LO, LA = np.meshgrid(-72.71 + np.linspace(-0.005, 0.005, 6), 11.02 + np.linspace(-0.005, 0.005, 6))
    alts = np.full(LO.size, TERRAIN_ALT)
    for p in bundles["paths"]:
        name = os.path.basename(p)[:-4] + ".rpc_adj"
        gj, gt = (np.stack(rpc_projection_np(rpc_from_rpc_file(os.path.join(o, "rpcs_adj", name)),
                                             LO.ravel(), LA.ravel(), alts), axis=1)
                  for o in (oj, ot))
        assert np.abs(gt - gj).max() <= 1e-2


@pytest.mark.parametrize("n_adj,n_new", [(0, 4), (1, 3), (4, 0), (2, 5)])
def test_default_pair_grid_matches_jax(n_adj, n_new):
    from sat_bundleadjust_tpu.tracks import predefined as jpre

    from sat_bundleadjust_tpu_torch.tracks import predefined as tpre

    got = tpre.default_pair_grid(n_adj, n_new)
    assert got == jpre.default_pair_grid(n_adj, n_new)
    assert all(j >= n_adj and i < j for i, j in got)
    if n_new == 0:
        assert got == []


@pytest.mark.parametrize("case", ["all", "missing_entry", "reordered_subset"])
def test_remap_bundle_matches_matches_jax(case):
    """resolve_bundle_indices and remap_bundle_matches: a target image absent
    from the manifest (its matches dropped, named as missing), the targets
    in another order than the manifest (rows canonicalized to im_i < im_j,
    keypoint columns swapped along)."""
    from sat_bundleadjust_tpu.tracks import predefined as jpre

    from sat_bundleadjust_tpu_torch.tracks import predefined as tpre

    manifest = ["/a/im{}.tif".format(k) for k in range(5)]
    rng = np.random.RandomState(0)
    ii = rng.randint(0, 5, 200)
    jj = (ii + rng.randint(1, 5, 200)) % 5
    matches = np.stack([rng.randint(0, 50, 200), rng.randint(0, 50, 200), ii, jj], axis=1)
    targets = {"all": manifest,
               "missing_entry": ["/b/im0.tif", "/b/im9.tif", "/b/im3.tif"],
               "reordered_subset": ["/c/im4.tif", "/c/im1.tif", "/c/im2.tif"]}[case]
    ind_t, miss_t = tpre.resolve_bundle_indices(manifest, targets)
    ind_j, miss_j = jpre.resolve_bundle_indices(manifest, targets)
    np.testing.assert_array_equal(ind_t, ind_j)
    assert miss_t == miss_j == (["im9.tif"] if case == "missing_entry" else [])
    got = tpre.remap_bundle_matches(matches, ind_t, len(manifest))
    np.testing.assert_array_equal(got, jpre.remap_bundle_matches(matches, ind_j, len(manifest)))
    assert np.all(got[:, 2] < got[:, 3]) and got[:, 3].max() < len(ind_t)
