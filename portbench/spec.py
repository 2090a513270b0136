"""Finds what BENCHMARK.json names: a cell's configuration, its traffic mix,
its limits and the reader of each per-layer metric, each a file of its own.

Under the folder `portbench/` of the benchmark's root:
  configs/<config>.json    the configuration (BENCHMARK.json's `file`)
  traffic/<traffic>.json   the traffic mix: `driver` (a module of
                           portbench/drivers/) and its parameters
  limits/<cell>.json       the limit of each number the check compares:
                           {"max": x} or {"min": x}
  metrics/<metric>.py      a reader: `read(run)` -> value, or None where the
                           run has nothing for it to read. `run` is
                           {"units": each unit's record (its walls, counters
                           and the program's own timings, as its driver
                           makes it), "trace": None, or the traced window's
                           busy_s, window_s and device_ops [(name, start_ns,
                           end_ns)]}
"""

import importlib
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path):
    with open(path) as f:
        return json.load(f)


class Spec:
    """The benchmark rooted at `root` (the directory of BENCHMARK.json)."""

    def __init__(self, root=ROOT):
        self.root = root
        self.dir = os.path.join(root, "portbench")
        self.bench = _json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, workload):
        """Everything one run of the cell `workload` needs."""
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError("no workload {!r} in BENCHMARK.json".format(workload))
        w = cells[workload]
        cfg_entry = {c["name"]: c for c in self.bench["configs"]}[w["config"]]
        traffic = _json(os.path.join(self.dir, "traffic", w["traffic"] + ".json"))
        return {
            "workload": w,
            "config": _json(os.path.join(self.root, cfg_entry["file"])),
            "traffic": traffic,
            "limits": _json(os.path.join(self.dir, "limits", workload + ".json")),
            "end_to_end": [m for m in self.bench["end_to_end"] if _in(m, workload)],
            "per_layer": [m for m in self.bench["per_layer"] if _in(m, workload)],
            "driver": importlib.import_module("portbench.drivers." + traffic["driver"]),
        }

    def reader(self, metric):
        """The `read` function of metrics/<metric>.py."""
        path = os.path.join(self.dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_")
                                                      .replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _in(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]
