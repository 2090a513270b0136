"""Driver `cli_scenes`: whole runs of the program's command line, one scene
after another, in process.

Set-up renders the configuration's views (frozen generator, fixed
texture), biases their RPCs by offsets drawn from the seed (view 0
unbiased) and writes them as .tif and .rpc files. Each unit is
`sat_bundleadjust_tpu_torch.cli.main([config.json])` on those files: a
fresh Scene that reads them and writes its outputs to a directory of its
own. The check judges each unit's files (portbench/reference/cli_outputs.py)
against the rendered truth.
"""

import json
import os
import shutil
import tempfile
import time

import torch

from portbench.reference import cli_outputs
from portbench.scenes import generate
from portbench.scenes import rpc as rpcm


class Scenes:
    def __init__(self, config, seed, device):
        from PIL import Image

        from sat_bundleadjust_tpu_torch import cli

        self.main, self.config, self.device = cli.main, config, device
        self.views = v = config["views"]
        frames, self.rpcs = generate.render_views(
            v["count"], v["h"], v["w"], v["alt"], v["n_tex"], v["tex_octaves"], v["texture_seed"],
            device)
        self.work = tempfile.mkdtemp(prefix="portbench-")
        self.images = os.path.join(self.work, "images")
        os.makedirs(self.images)
        self.view_of = {}
        for k, (frame, rpc, b) in enumerate(zip(frames, self.rpcs,
                                                generate.biases(v["count"], v["bias_px"], seed))):
            name = "20200413_1514{:02d}_view{}".format(10 + k, k)
            Image.fromarray(frame).save(os.path.join(self.images, name + ".tif"))
            rpcm.write_file(dict(rpc, col_offset=rpc["col_offset"] + b[0],
                                 row_offset=rpc["row_offset"] + b[1]),
                            os.path.join(self.images, name + ".rpc"))
            self.view_of[name] = k
        self.sizes = {"views": v["count"], "h": v["h"], "w": v["w"]}

    def __call__(self, i):
        out = os.path.join(self.work, "scene{}".format(i))
        cfg = dict(self.config["cli"], geotiff_dir=self.images, rpc_dir=self.images,
                   output_dir=out)
        path = out + ".json"
        with open(path, "w") as f:
            json.dump(cfg, f)
        t0 = time.perf_counter()
        scene = self.main([path])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        pipe = scene.ba_pipeline
        timing = dict(scene.timing, **pipe.timing)
        return {"wall_s": wall, "timing": timing, "ft_timing": dict(pipe.ft_timing),
                "rounds": [dict(r) for r in pipe.ba_rounds],
                "answer": os.path.join(out, cfg["ba_method"])}

    def judge(self, ba_dir, rounding=(torch.float64, torch.float32)):
        v = self.views
        return cli_outputs.judge(ba_dir, self.view_of, self.rpcs, v["h"], v["w"], v["alt"],
                                 rounding=rounding)

    def close(self):
        shutil.rmtree(self.work, ignore_errors=True)


make = Scenes


def describe(records):
    """Stage walls (mean per scene) and LM counts, for the run's earlier lines."""
    def mean(key):
        return {k: sum(r[key][k] for r in records) / len(records) for k in records[0][key]}

    return {"stage_s": mean("timing"), "tracks_s": mean("ft_timing"),
            "lm_iterations": [[x["iterations"] for x in r["rounds"]] for r in records]}


def check(scenes, records):
    """Each scene's outputs, judged."""
    return [scenes.judge(r["answer"]) for r in records]


def control(scenes, records):
    """The control: each scene's outputs in the precision below the
    configuration's (geometry float64 -> float32, keypoint coordinates
    float32 -> bfloat16), judged."""
    return [scenes.judge(r["answer"], rounding=(torch.float32, torch.bfloat16)) for r in records]
