"""The port's whole pipeline on two processes (gloo ranks on the CPU) with
`"distributed": true`, against the JAX package's in-process run of the same
config on a 2-device mesh (tests/test_multihost.py:83-163's scene: 4 views
of 300x400 px from utils/demo.render_synthetic_images, seed 3, RPC biases
of +-3 px on cameras 1-3).

Checks: each rank detected only its own images (0, 2 and 1, 3) and matched
only its own pairs; both BA rounds ran on the distributed solver; rank 0
alone wrote the outputs (its save_corrected_cameras ran, rank 1's did
not); both ranks report the same tracks and errors; the four .rpc_adj
files project a ground grid within 1e-2 px of the JAX run's.

Run as a program, this file is one rank's worker:
    python tests/test_torch_multihost.py <rank> <world> <port> <config.json>
"""

import glob
import json
import os
import sys

import numpy as np

GRID_LON = -72.71 + np.linspace(-0.01, 0.01, 9)
GRID_LAT = 11.02 + np.linspace(-0.01, 0.01, 9)
ALT = 50.0
CONFIG = {
    "rpc_src": "txt",
    "cam_model": "rpc",
    "ba_method": "ba_bruteforce",
    "FT_kp_max": 3000,
    "FT_sift_detection": "tpu",
    "FT_sift_matching": "bruteforce",
    "clean_outliers": True,
    "save_figures": False,
    "distributed": True,
}


def write_scene(root):
    """The rendered views (.tif) and their biased RPCs (.rpc) in
    root/images; returns the image directory."""
    from PIL import Image

    from sat_bundleadjust_tpu_torch.models.rpc import write_rpc_file
    from sat_bundleadjust_tpu_torch.utils.demo import render_synthetic_images

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    images, true_rpcs = render_synthetic_images(n_cam=4, h=300, w=400, seed=3, device="cpu")
    rng = np.random.RandomState(11)
    for i, (im, rpc) in enumerate(zip(images, true_rpcs)):
        bias = np.zeros(2) if i == 0 else rng.uniform(-3, 3, 2)
        biased = rpc._replace(col_offset=rpc.col_offset + bias[0],
                              row_offset=rpc.row_offset + bias[1])
        name = "20200413_1514{:02d}_synth_cam{}".format(10 + i, i)
        Image.fromarray((im * 255).astype(np.uint8)).save(os.path.join(img_dir, name + ".tif"))
        write_rpc_file(biased, os.path.join(img_dir, name + ".rpc"))
    return img_dir


def write_config(root, name, img_dir):
    cfg = dict(CONFIG, geotiff_dir=img_dir, rpc_dir=img_dir,
               output_dir=os.path.join(root, "out_" + name))
    path = os.path.join(root, "config_{}.json".format(name))
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, os.path.join(cfg["output_dir"], "ba_bruteforce")


def _worker(rank, world, port, config):
    import torch

    import sat_bundleadjust_tpu_torch
    from sat_bundleadjust_tpu_torch.ops import sift
    from sat_bundleadjust_tpu_torch.parallel import multihost
    from sat_bundleadjust_tpu_torch.pipeline import BundleAdjustmentPipeline
    from sat_bundleadjust_tpu_torch.tracks import matching

    torch.set_num_threads(1)
    multihost.initialize("127.0.0.1:" + port, int(world), int(rank), backend="gloo")
    seen = {"images": 0, "pairs": 0, "writes": 0}
    detect, match, save = (sift.detect_sift_batch, matching.match_ops.match_pairs_2nn_batched,
                           BundleAdjustmentPipeline.save_corrected_cameras)

    def counted_detect(images, *args, **kwargs):
        seen["images"] += len(images)
        return detect(images, *args, **kwargs)

    def counted_match(pair_feats, *args, **kwargs):
        seen["pairs"] += len(pair_feats)
        return match(pair_feats, *args, **kwargs)

    def counted_save(self):
        seen["writes"] += 1
        return save(self)

    sift.detect_sift_batch = counted_detect
    matching.match_ops.match_pairs_2nn_batched = counted_match
    BundleAdjustmentPipeline.save_corrected_cameras = counted_save
    scene = sat_bundleadjust_tpu_torch.main(config, device="cpu")
    pipe = scene.ba_pipeline
    print("MULTIHOST_RESULT " + json.dumps({
        "rank": int(rank), "seen": seen, "distributed_rounds": [
            "allreduces" in r for r in pipe.ba_rounds],
        "tracks": int(pipe.C.shape[1]), "init_e": float(np.mean(pipe.init_e)),
        "ba_e": float(np.mean(pipe.ba_e)), "iters": int(pipe.ba_iters)}), flush=True)
    torch.distributed.destroy_process_group()


def _projections(out_dir):
    from sat_bundleadjust_tpu_torch.models.rpc import rpc_from_rpc_file, rpc_projection_np

    files = sorted(glob.glob(os.path.join(out_dir, "rpcs_adj", "*.rpc_adj")))
    LO, LA = np.meshgrid(GRID_LON, GRID_LAT)
    alts = np.full(LO.size, ALT)
    return files, [np.stack(rpc_projection_np(rpc_from_rpc_file(f), LO.ravel(), LA.ravel(), alts),
                            axis=1) for f in files]


def test_two_process_pipeline_matches_jax(tmp_path):
    import sat_bundleadjust_tpu
    from sat_bundleadjust_tpu.parallel.mesh import make_mesh, set_default_mesh
    from test_torch_ranks import start_ranks, wait_ranks

    root = str(tmp_path)
    img_dir = write_scene(root)
    cfg_t, out_t = write_config(root, "torch", img_dir)
    cfg_j, out_j = write_config(root, "jax", img_dir)
    procs = start_ranks(__file__, [cfg_t], 2)
    try:
        set_default_mesh(make_mesh(n_devices=2))
        scene_j = sat_bundleadjust_tpu.main(cfg_j)
    finally:
        set_default_mesh(None)
    outs = wait_ranks(procs, timeout=420)

    res = []
    for out in outs:
        line = [x for x in out.splitlines() if x.startswith("MULTIHOST_RESULT ")]
        assert line, out[-4000:]
        res.append(json.loads(line[-1][len("MULTIHOST_RESULT "):]))
    # per-process work: images 0, 2 and 1, 3; the six pairs three and three
    assert [r["seen"]["images"] for r in res] == [2, 2]
    assert [r["seen"]["pairs"] for r in res] == [3, 3]
    # one writer
    assert [r["seen"]["writes"] for r in res] == [1, 0]
    # every BA round on the distributed solver; the ranks agree
    assert all(r["distributed_rounds"] == [True, True] for r in res)
    for k in ("tracks", "init_e", "ba_e", "iters"):
        assert res[0][k] == res[1][k], k

    files_t, proj_t = _projections(out_t)
    files_j, proj_j = _projections(out_j)
    assert [os.path.basename(f) for f in files_t] == [os.path.basename(f) for f in files_j]
    assert len(files_t) == 4
    gap = max(float(np.abs(a - b).max()) for a, b in zip(proj_t, proj_j))
    assert gap < 1e-2, gap
    pipe_j = scene_j.ba_pipeline
    assert res[0]["tracks"] == pipe_j.C.shape[1]
    assert res[0]["ba_e"] < 0.5 * res[0]["init_e"]
    assert abs(res[0]["ba_e"] - float(np.mean(pipe_j.ba_e))) < 1e-3


if __name__ == "__main__":
    _worker(*sys.argv[1:])
