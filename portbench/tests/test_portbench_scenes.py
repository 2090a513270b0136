"""The frozen scene generators give the program's demo scenes (utils/demo)
draw for draw, and the seed reorders a problem without changing the
program's work."""

import numpy as np
import torch

from portbench.scenes import generate
from portbench.scenes import rpc as rpcm


def test_ba_problem_is_the_demos():
    from sat_bundleadjust_tpu_torch.utils import demo

    cpu = torch.device("cpu")
    mine = generate.ba_problem(12, 300, 4, 2e-5, 0.1, 1.0, 7, cpu)
    theirs = demo.make_scene_arrays(n_cam=12, n_pts=300, obs_per_pt=4, seed=7, device=cpu)
    for a, b in (("params_true", "cam_params_true"), ("params0", "cam_params0"),
                 ("centers", "camera_centers"), ("pts3d", "pts3d"), ("cam_ind", "cam_ind"),
                 ("pts_ind", "pts_ind")):
        np.testing.assert_array_equal(mine[a], theirs[b])
    np.testing.assert_allclose(mine["pts2d"], theirs["pts2d"], rtol=0, atol=1e-9)
    p = demo.scene_to_baparams(theirs)
    np.testing.assert_array_equal(mine["pts0"], p.pts3d[np.argsort(p.pts_prev_indices)])
    for r, t in zip(mine["rpcs"], theirs["rpc_list"]):
        for k in rpcm.FIELDS:
            np.testing.assert_array_equal(np.asarray(r[k]), np.asarray(getattr(t, k)))


def test_render_views_are_the_demos():
    from sat_bundleadjust_tpu_torch.utils import demo

    cpu = torch.device("cpu")
    frames, rpcs = generate.render_views(3, 90, 120, 50.0, 256, 3, 4, cpu, block_rows=32)
    ims, _ = demo.render_synthetic_images(n_cam=3, h=90, w=120, seed=4, alt=50.0, n_tex=256,
                                          tex_octaves=3, device=cpu)
    for f, im in zip(frames, ims):
        np.testing.assert_array_equal(f, (im * 255).astype(np.uint8))


def test_shuffle_keeps_the_problem():
    cpu = torch.device("cpu")
    base = generate.ba_problem(10, 200, 4, 2e-5, 0.1, 1.0, 0, cpu)
    a, b = generate.shuffle(base, 1), generate.shuffle(base, 2 ** 31 + 9)
    assert not np.array_equal(a["cam_ind"], b["cam_ind"])
    for q in (a, b):
        order = np.lexsort((q["cam_ind"], q["pts_ind"]))
        ref = np.lexsort((base["cam_ind"], base["pts_ind"]))
        for k in ("cam_ind", "pts_ind", "pts2d"):
            np.testing.assert_array_equal(q[k][order], base[k][ref])
    np.testing.assert_array_equal(generate.biases(4, 3.0, 11), generate.biases(4, 3.0, 11))
    assert not generate.biases(4, 3.0, 11)[0].any()


def test_rpc_files_round_trip(tmp_path):
    r = rpcm.synthetic_rpc(view_dx=12.5)
    rpcm.write_file(r, str(tmp_path / "a.rpc"))
    back = rpcm.read_file(str(tmp_path / "a.rpc"))
    for k in rpcm.FIELDS:
        np.testing.assert_allclose(np.asarray(back[k]), np.asarray(r[k]), rtol=0, atol=1e-12)


def test_the_seed_does_not_change_the_programs_work():
    from portbench.drivers import ba_stages

    cfg = {"n_cam": 12, "n_pts": 600, "obs_per_pt": 4, "rot_scale": 2e-5, "noise_px": 0.1,
           "noise_pts_m": 1.0, "scene_seed": 0}
    cpu = torch.device("cpu")
    a, b = (ba_stages.make(cfg, seed, cpu)(0) for seed in (3, 2 ** 31 + 77))
    assert a["rounds"][0]["iterations"] == b["rounds"][0]["iterations"]
    for x, y in zip(a["answer"], b["answer"]):
        np.testing.assert_array_equal(x, y)


def test_the_seeds_own_problem_differs_in_its_noise_alone():
    cpu = torch.device("cpu")
    base = generate.ba_problem(10, 200, 4, 2e-5, 0.1, 1.0, 0, cpu)
    a, b = (generate.ba_problem(10, 200, 4, 2e-5, 0.1, 1.0, 0, cpu, noise_seed=s)
            for s in (5, 2 ** 31 + 5))
    for q in (a, b):
        for k in ("params_true", "params0", "pts3d", "pts0", "cam_ind", "pts_ind"):
            np.testing.assert_array_equal(q[k], base[k])
        gap = q["pts2d"] - base["pts2d"]
        assert 0.05 < gap.std() < 0.3
    assert not np.array_equal(a["pts2d"], b["pts2d"])
