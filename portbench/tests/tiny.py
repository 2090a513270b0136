"""A copy of the benchmark at sizes a CPU test can run: the same files,
the configurations cut down, in a directory of its own."""

import json
import os
import shutil

import torch

from portbench import spec as specm

TINY = {
    "rpc_date10": {"views": {"count": 4, "h": 400, "w": 400, "n_tex": 512, "tex_octaves": 4},
                   "cli": {"FT_kp_max": 3000}},
    "rpc_ba1000": {"n_cam": 16, "n_pts": 1500},
}
# the count floors follow the size: 4 views of 400 x 400 px give 1 493
# keypoints a view, each matched in every pair and seen in one track
TINY_LIMITS = {
    "rpc_date10.cli": {"pair_matches_min": {"min": 1300}, "view_tracks_min": {"min": 1300}},
}


def tiny_spec(root):
    """The benchmark copied under root, with TINY's sizes and TINY_LIMITS'
    floors. Returns its Spec."""
    shutil.copy(os.path.join(specm.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(specm.ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, cut in TINY.items():
        path = os.path.join(root, "portbench", "configs", name + ".json")
        with open(path) as f:
            cfg = json.load(f)
        for k, v in cut.items():
            if isinstance(v, dict):
                cfg[k].update(v)
            else:
                cfg[k] = v
        with open(path, "w") as f:
            json.dump(cfg, f)
    for cell, cut in TINY_LIMITS.items():
        path = os.path.join(root, "portbench", "limits", cell + ".json")
        with open(path) as f:
            limits = json.load(f)
        limits.update(cut)
        with open(path, "w") as f:
            json.dump(limits, f)
    return specm.Spec(root)


def on_the_cpu(monkeypatch):
    """The program's default device becomes the CPU (its command line asks
    for the card)."""
    import sat_bundleadjust_tpu_torch as pkg

    real = pkg.resolve_device
    monkeypatch.setattr(pkg, "resolve_device",
                        lambda device=None: real(torch.device("cpu") if device is None else device))
