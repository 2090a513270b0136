"""Driver `ts_scenes`: whole runs of the program's command line on a
multi-date series in `ba_sequential`, one series after another, in process.

Set-up renders the series (portbench/scenes/series.py: each date its own
positions on the view ring and its own change of the ground), biases the
views' RPCs by offsets drawn from the seed (view 0 of date 0 unbiased) and
writes them as .tif and .rpc files named YYYYMMDD_HHMMSS_*, so that the
program groups them into dates. Each unit is
`sat_bundleadjust_tpu_torch.cli.main([config.json])` on those files: a
fresh Scene that reads them and adjusts the dates one after another, each
against its frozen predecessors, in an output directory of its own. The
record carries the Scene's `date_stats`, each date's wall, and the dates'
stage walls summed as a CLI run's record has them (`timing`, `ft_timing`).
The check judges each unit's files (portbench/reference/ts_outputs.py)
against the rendered truth, and the program's cache counts: nothing that
an earlier date left in the caches computed again.
"""

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench.reference import ts_outputs
from portbench.scenes import generate
from portbench.scenes import rpc as rpcm
from portbench.scenes import series

# date_stats' entries that the record keeps (JSON numbers and dicts)
KEPT = ("time", "time_FT", "tracks", "init_e", "ba_e", "iters", "n_adj", "reproj_after",
        "timing", "ft_timing", "ft_counts", "date_s")


class Scenes:
    def __init__(self, config, seed, device):
        from PIL import Image

        from sat_bundleadjust_tpu_torch import cli

        self.main, self.config, self.device = cli.main, config, device
        self.views = v = config["views"]
        n_dates, per_date = config["dates"], v["per_date"]
        frames, rpcs = series.render_series(
            n_dates, per_date, v["h"], v["w"], v["alt"], v["n_tex"], v["tex_octaves"],
            v["texture_seed"], config["change"], device)
        self.dates = series.names(n_dates, per_date, v["days_apart"], v["seconds_apart"])
        self.work = tempfile.mkdtemp(prefix="portbench-")
        self.images = os.path.join(self.work, "images")
        os.makedirs(self.images)
        bias = generate.biases(n_dates * per_date, v["bias_px"], seed)
        self.rpcs = {}
        for d in range(n_dates):
            for k in range(per_date):
                name, rpc, b = self.dates[d][k], rpcs[d][k], bias[d * per_date + k]
                Image.fromarray(frames[d][k]).save(os.path.join(self.images, name + ".tif"))
                rpcm.write_file(dict(rpc, col_offset=rpc["col_offset"] + b[0],
                                     row_offset=rpc["row_offset"] + b[1]),
                                os.path.join(self.images, name + ".rpc"))
                self.rpcs[name] = rpc
        self.sizes = {"dates": n_dates, "views_per_date": per_date, "h": v["h"], "w": v["w"]}

    def __call__(self, i):
        out = os.path.join(self.work, "series{}".format(i))
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
        stats = {k: [_plain(x) for x in scene.date_stats[k]] for k in KEPT
                 if k in scene.date_stats}
        # a program without the dates' own walls: the walls of their BA runs
        return {"wall_s": wall, "date_s": stats.get("date_s", stats["time"]),
                "date_stats": stats,
                "timing": dict(scene.timing, **_summed(stats["timing"])),
                "ft_timing": _summed(stats["ft_timing"]),
                "answer": os.path.join(out, cfg["ba_method"])}

    def judge(self, ba_dir, rounding=(torch.float64, torch.float32)):
        v = self.views
        return ts_outputs.judge(ba_dir, self.dates, self.config["cli"]["n_dates"], self.rpcs,
                                v["h"], v["w"], v["alt"], rounding=rounding)

    def close(self):
        shutil.rmtree(self.work, ignore_errors=True)


def _plain(x):
    """A date_stats entry as JSON numbers."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    return x


def _summed(dicts):
    """The dates' walls of each stage, summed over the series (the walls
    of a CLI run's record, as the CLI cell's readers take them)."""
    out = {}
    for d in dicts:
        for k, v in d.items():
            if isinstance(v, (int, float)):
                out[k] = out.get(k, 0.0) + v
    return out


def recomputed(record, per_date):
    """What the series computed again of the state its earlier dates left,
    summed over the dates after the first, from the program's cache counts
    (`date_stats["ft_counts"]`; `per_date`: the views of a date): the
    frozen views' keypoints detected again (features_detected beyond the
    date's own views) and the pairs between the frozen views matched again
    (f (f - 1) / 2 beyond pairs_cached, f the frozen views; every pair of a
    date's views overlaps in this scene, so each was matched and cached). A
    program that keeps no cache counts reads 0."""
    counts = record["date_stats"].get("ft_counts")
    if counts is None:
        return 0
    total = 0
    for c in counts[1:]:
        frozen = c["features_cached"] + c["features_detected"] - per_date
        total += (max(0, c["features_detected"] - per_date)
                  + max(0, frozen * (frozen - 1) // 2 - c["pairs_cached"]))
    return total


def later_dates(run):
    """The traced `ts.date` spans of the dates after a series' first (the
    readers of portbench/metrics/ts.*.py)."""
    from portbench import spans

    kept = spans.recorded(run)
    return [s for s in spans.named(kept or [], ("ts.date",)) if s[5].get("date", 0) > 0]


make = Scenes


def describe(records):
    """Each date's wall, tracks front end, stage walls, the front end's
    stage walls and cache counts (mean per series), and the dates' LM
    iterations, for the run's earlier lines."""
    def mean(values):
        if isinstance(values[0], dict):
            return {k: mean([v[k] for v in values]) for k in values[0]}
        return sum(values) / len(values)

    def per_date(key):
        if any(key not in r["date_stats"] for r in records):
            return None
        return [mean(list(x)) for x in zip(*(r["date_stats"][key] for r in records))]

    return {"date_s": [mean(list(x)) for x in zip(*(r["date_s"] for r in records))],
            "tracks_s": per_date("time_FT"), "stage_s": per_date("timing"),
            "tracks_stage_s": per_date("ft_timing"), "cache_counts": per_date("ft_counts"),
            "lm_iterations": [r["date_stats"]["iters"] for r in records]}


def check(scenes, records):
    """Each series' outputs, judged, and what it computed again of the
    caches (`recomputed`)."""
    return [dict(scenes.judge(r["answer"]), recomputed=recomputed(r, scenes.views["per_date"]))
            for r in records]


def control(scenes, records):
    """The control: each series' outputs in the precision below the
    configuration's (geometry float64 -> float32, keypoint coordinates
    float32 -> bfloat16), judged; `recomputed` as the check's."""
    return [dict(scenes.judge(r["answer"], rounding=(torch.float32, torch.bfloat16)),
                 recomputed=recomputed(r, scenes.views["per_date"])) for r in records]
