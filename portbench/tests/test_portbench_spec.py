"""BENCHMARK.json against the contract's form, and the harness finding a
configuration, a traffic mix and a per-layer metric that were added as new
files and entries, with no file that was there edited."""

import hashlib
import json
import os
import re

import pytest
import torch

from portbench import run as runm
from portbench import spec as specm
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(specm.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_has_the_contracts_form():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43 200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/configs/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        with open(os.path.join(specm.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        names.add(c["name"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = [e for e in b["end_to_end"] if e["name"] == m["moves"]]
        assert moved and set(m["workloads"]) <= set(moved[0]["workloads"])
        assert os.path.exists(os.path.join(specm.ROOT, "portbench", "metrics", m["name"] + ".py"))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and w["config"] in names and len(w["why"]) <= 200
        e2e = [m["name"] for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in b["per_layer"])
        cell = specm.Spec().cell(w["name"])
        assert cell["traffic"]["unit_metric"] in e2e and cell["limits"]
        assert all(list(lim) in (["max"], ["min"]) for lim in cell["limits"].values())


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_config_traffic_and_metric_are_new_files_and_entries(tmp_path):
    spec = tiny.tiny_spec(str(tmp_path))
    before = _digests(str(tmp_path / "portbench"))
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "rpc_ba1000.json").read_text())
    cfg.update(name="rpc_ba24", n_cam=24, n_pts=1200)
    (pb / "configs" / "rpc_ba24.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "stage_short.json").write_text(json.dumps(
        {"driver": "ba_stages", "unit_metric": "ba_stage_s", "trace_units": 1}))
    (pb / "limits" / "rpc_ba24.stage_short.json").write_text(json.dumps(
        {"cost_excess": {"max": 1e-2}, "cam_gap_px": {"max": 0.05}}))
    (pb / "metrics" / "lm.iterations.ba.py").write_text(
        "def read(run):\n"
        "    return sum(r['iterations'] for u in run['units'] for r in u['rounds'])"
        " / len(run['units'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "rpc_ba24", "source": "https://example.org/a-paper",
                             "file": "portbench/configs/rpc_ba24.json", "reduced": [],
                             "why": "a small problem"})
    bench["workloads"].append({"name": "rpc_ba24.stage_short", "config": "rpc_ba24",
                               "traffic": "stage_short", "chips": 1, "why": "small stages"})
    for m in bench["end_to_end"]:
        if m["name"] == "ba_stage_s":
            m["workloads"].append("rpc_ba24.stage_short")
    bench["per_layer"].append({"name": "lm.iterations.ba", "unit": "1", "better": "lower",
                               "source": "program_counter", "layer": "ops.lm",
                               "moves": "ba_stage_s", "workloads": ["rpc_ba24.stage_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = specm.Spec(str(tmp_path))
    cell = spec.cell("rpc_ba24.stage_short")
    assert cell["config"]["n_cam"] == 24 and cell["traffic"]["trace_units"] == 1
    assert [m["name"] for m in cell["per_layer"]] == ["lm.iterations.ba"]
    result = runm.run("rpc_ba24.stage_short", 5, 0.5, 0, spec=spec, device=torch.device("cpu"))
    assert result["correct"] and set(result["metrics"]) == {"setup_s", "ba_stage_s"}
    assert spec.reader("lm.iterations.ba")({"units": [{"rounds": [{"iterations": 7}]}]}) == 7
    after = _digests(str(pb))
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"configs/rpc_ba24.json", "traffic/stage_short.json",
                                        "limits/rpc_ba24.stage_short.json",
                                        "metrics/lm.iterations.ba.py"}


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        specm.Spec().cell("rpc_date10.nothing")
