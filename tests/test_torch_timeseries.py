"""The time-series modes of the port (`ba_sequential`, `ba_global`) against
the JAX package's, through both packages' `Scene` on one rendered scene,
on the CPU (device="cpu").

The scene is tests/test_timeseries.py's: two dates a week apart, 2 views
of 150x200 each, RPC biases of up to +-3 px on every camera but camera 0
of the first date; its config (bruteforce matching, FT_kp_max 1500,
save_figures False). Compared against the JAX runs:
- the .rpc_adj files: the same names, projecting a ground grid within
  1e-2 px of JAX's (the bar of tests/test_torch_e2e.py);
- ba_sequential: date 2 ran with the adjusted cameras of date 1
  (n_adj = 2) as JAX's did, and wrote the same pts3d_adj/<date>_pts3d_adj
  .ply files, with as many points, within 1e-6 rad x the camera distance
  of JAX's as sets (tests/test_torch_e2e.py's bar);
- check_adjusted_dates marks the same dates;
- load_pairs_from_same_date_and_next_dates equals JAX's on a few
  timelines.
"""

import glob
import os

import numpy as np
import pytest

from test_e2e import TERRAIN_ALT, render_image, world_texture

GRID_LON = -72.71 + np.linspace(-0.006, 0.006, 7)
GRID_LAT = 11.02 + np.linspace(-0.006, 0.006, 7)
CAM_DIST = 6.0e5  # m: the synthetic cameras' distance scale for the point bar


@pytest.fixture(scope="module")
def two_date_scene(tmp_path_factory):
    from PIL import Image

    from sat_bundleadjust_tpu.models.rpc import write_rpc_file
    from sat_bundleadjust_tpu.utils.demo import make_synthetic_rpc

    root = tmp_path_factory.mktemp("torch_ts_scene")
    img_dir = root / "images"
    img_dir.mkdir()
    tex = world_texture()
    h, w = 150, 200
    rng = np.random.RandomState(5)
    for d, datecode in enumerate(["20200413_151400", "20200420_151400"]):
        for i in range(2):
            idx = 2 * d + i
            rpc = make_synthetic_rpc(view_dx=230.0 * np.cos(np.pi * idx / 2 + 0.3),
                                     view_dy=230.0 * np.sin(np.pi * idx / 2 + 0.3),
                                     img_halfsize=(w / 2, h / 2))
            bias = np.zeros(2) if idx == 0 else rng.uniform(-3, 3, 2)
            biased = rpc._replace(col_offset=rpc.col_offset + bias[0],
                                  row_offset=rpc.row_offset + bias[1])
            name = "{}_synth_cam{}".format(datecode[:-2] + "{:02d}".format(i), idx)
            Image.fromarray(render_image(rpc, tex, h, w)).save(str(img_dir / (name + ".tif")))
            write_rpc_file(biased, str(img_dir / (name + ".rpc")))
    return str(root)


def _cfg(root, pkg, method):
    return {
        "geotiff_dir": os.path.join(root, "images"),
        "rpc_dir": os.path.join(root, "images"),
        "rpc_src": "txt",
        "cam_model": "rpc",
        "output_dir": os.path.join(root, "out_{}_{}".format(pkg, method)),
        "ba_method": method,
        "n_dates": 1,
        "FT_kp_max": 1500,
        "FT_sift_detection": "tpu",
        "FT_sift_matching": "bruteforce",
        "save_figures": False,
    }


@pytest.fixture(scope="module")
def runs(two_date_scene):
    """Both packages' Scene for both modes; the port's pipeline n_adj of
    each sequential date is recorded by wrapping Scene.bundle_adjust."""
    from sat_bundleadjust_tpu.timeseries import Scene as JScene

    from sat_bundleadjust_tpu_torch.timeseries import Scene as TScene

    out = {}
    for method in ("ba_sequential", "ba_global"):
        for pkg, cls, kw in (("jax", JScene, {}), ("torch", TScene, {"device": "cpu"})):
            scene = cls(_cfg(two_date_scene, pkg, method), **kw)
            seen = []
            run = scene.bundle_adjust

            def wrapped(run=run, scene=scene, seen=seen):
                res = run()
                seen.append(scene.ba_pipeline.n_adj)
                return res

            scene.bundle_adjust = wrapped
            scene.run_bundle_adjustment_for_RPC_refinement()
            out[(pkg, method)] = (scene, seen)
    return out


def _ba_dir(scene):
    return os.path.join(scene.dst_dir, scene.ba_method)


def _grid(path):
    from sat_bundleadjust_tpu_torch.models.rpc import rpc_from_rpc_file, rpc_projection_np

    LO, LA = np.meshgrid(GRID_LON, GRID_LAT)
    rpc = rpc_from_rpc_file(path)
    return np.stack(rpc_projection_np(rpc, LO.ravel(), LA.ravel(),
                                      np.full(LO.size, TERRAIN_ALT)), axis=1)


@pytest.mark.parametrize("method", ["ba_sequential", "ba_global"])
def test_rpc_adj_match_jax(runs, method):
    """Four .rpc_adj files of the same names, each projecting the ground
    grid within 1e-2 px of the JAX run's; the adjusted models are closer
    to each other than to the biased input."""
    sj, st = runs[("jax", method)][0], runs[("torch", method)][0]
    fj = sorted(glob.glob(os.path.join(_ba_dir(sj), "rpcs_adj", "*.rpc_adj")))
    ft = sorted(glob.glob(os.path.join(_ba_dir(st), "rpcs_adj", "*.rpc_adj")))
    assert len(ft) == 4
    assert [os.path.basename(f) for f in ft] == [os.path.basename(f) for f in fj]
    gap = max(np.abs(_grid(a) - _grid(b)).max() for a, b in zip(fj, ft))
    assert gap <= 1e-2, gap
    assert float(np.mean(st.ba_pipeline.ba_e)) < 0.5


def test_sequential_second_date_sees_the_first_frozen(runs):
    """Date 2 ran with date 1's two adjusted cameras (n_adj 2), in both
    packages; date 1 is marked adjusted; the per-date point clouds have
    the same names and as many points, and lie within 1e-6 rad x the
    camera distance of JAX's as sets."""
    (sj, nj), (st, nt) = runs[("jax", "ba_sequential")], runs[("torch", "ba_sequential")]
    assert nt == nj == [0, 2], (nt, nj)
    assert st.date_stats["n_adj"] == [0, 2]
    assert [d["adjusted"] for d in st.timeline] == [d["adjusted"] for d in sj.timeline]
    assert st.timeline[0]["adjusted"]
    from sat_bundleadjust_tpu_torch.utils.io import read_point_cloud_ply

    pj = sorted(glob.glob(os.path.join(_ba_dir(sj), "pts3d_adj", "*_pts3d_adj.ply")))
    pt = sorted(glob.glob(os.path.join(_ba_dir(st), "pts3d_adj", "*_pts3d_adj.ply")))
    assert [os.path.basename(p) for p in pt] == [os.path.basename(p) for p in pj]
    assert len(pt) == 2
    for a, b in zip(pj, pt):
        xa, xb = read_point_cloud_ply(a), read_point_cloud_ply(b)
        assert xa.shape == xb.shape
        d = np.linalg.norm(xb[:, None, :] - xa[None, :, :], axis=2).min(axis=1)
        assert d.max() <= 1e-6 * CAM_DIST, d.max()


def test_check_adjusted_dates_marks_the_same_dates(runs):
    """After the sequential run, both packages' check_adjusted_dates find
    the adjusted dates before each index, and mark the same ones."""
    sj, st = runs[("jax", "ba_sequential")][0], runs[("torch", "ba_sequential")][0]
    for t_idx in (0, 1, 2):
        for s in (sj, st):
            for d in s.timeline:
                d["adjusted"] = False
        fj = sj.check_adjusted_dates(_ba_dir(sj), t_idx)
        ft = st.check_adjusted_dates(_ba_dir(st), t_idx)
        assert ft == fj
        assert [d["adjusted"] for d in st.timeline] == [d["adjusted"] for d in sj.timeline]


@pytest.mark.parametrize("sizes,indices,next_dates", [
    ([2, 2, 1], [0, 1, 2], 1),
    ([3, 1, 2, 4], [0, 1, 2, 3], 2),
    ([2, 3, 1, 2], [1, 3], 1),
    ([1, 1, 1], [0, 1, 2], 0),
])
def test_load_pairs_from_same_date_and_next_dates_matches_jax(sizes, indices, next_dates):
    from sat_bundleadjust_tpu.timeseries import load_pairs_from_same_date_and_next_dates as jpairs

    from sat_bundleadjust_tpu_torch.timeseries import load_pairs_from_same_date_and_next_dates

    timeline = [{"n_images": n} for n in sizes]
    want = jpairs(timeline, indices, next_dates)
    got = load_pairs_from_same_date_and_next_dates(timeline, indices, next_dates)
    assert got == [(int(a), int(b)) for a, b in want]
