"""The time series cell's plain reference (portbench/reference/ts_outputs.py)
on a tiny seeded series run through the port's command line in
`ba_sequential` on the CPU: 3 dates of 3 views of 400 x 400 px,
`FT_kp_max` 3000 (portbench/tests/tiny_series.py). A sound series passes
every limit of the cell; a series whose dates were adjusted each on its own
(`dates_alone`) or whose frozen cameras were adjusted again
(`frozen_moved`) fails one (portbench/faults_series.py; two dates of the
series suffice for them, and they read the sound series' keypoints from
its cache, the faults acting after detection); `recomputed` counts what a series computed again of its
caches; `series_bias_px` takes out a shift common to every view exactly
and sees a shift of one date; the reference and the scene load nothing of
the port or of JAX."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import faults_series
from portbench import run as runm
from portbench import spec as specm
from portbench.drivers import ts_scenes
from portbench.reference import cli_outputs
from portbench.scenes import generate, series
from portbench.tests import tiny, tiny_series

CPU = torch.device("cpu")
WORKLOAD = "rpc_ts5x4.sequential"


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    spec = tiny_series.tiny_spec(str(tmp_path_factory.mktemp("tiny")))
    return spec.cell(WORKLOAD)


@pytest.fixture(scope="module")
def units(cell):
    """The tiny series' inputs, from a seed beyond 32 bits, and its first
    (sound) unit."""
    mp = pytest.MonkeyPatch()
    tiny.on_the_cpu(mp)
    scenes = cell["driver"].make(cell["config"], 2 ** 31 + 11, CPU)
    try:
        yield scenes, scenes(0)
    finally:
        scenes.close()
        mp.undo()


def _failed(numbers, limits):
    return sorted(k for k, lim in limits.items() if runm.judge([numbers], {k: lim})[0])


def test_a_sound_series_passes_every_limit(cell, units):
    scenes, rec = units
    numbers = cell["driver"].check(scenes, [rec])[0]
    assert _failed(numbers, cell["limits"]) == [], numbers
    assert numbers["recomputed"] == 0
    dates = len(scenes.dates)
    assert rec["date_stats"]["n_adj"] == [0] + [3] * (dates - 1)
    # every earlier date's keypoints and same-date pairs come from the caches
    counts = rec["date_stats"]["ft_counts"]
    assert counts[0] == {"features_cached": 0, "features_detected": 3, "pairs_cached": 0,
                         "pairs_matched": 3}
    assert all(c == {"features_cached": 3, "features_detected": 3, "pairs_cached": 3,
                     "pairs_matched": 12} for c in counts[1:]), counts
    json.dumps(cell["driver"].describe([rec]))


def test_the_control_fails_a_limit(cell, units):
    scenes, rec = units
    numbers = cell["driver"].control(scenes, [rec])[0]
    assert _failed(numbers, cell["limits"]), numbers


@pytest.mark.parametrize("fault,fails", [
    ("dates_alone", "series_bias_px"),
    ("frozen_moved", None),
])
def test_a_planted_fault_fails_a_limit(cell, units, monkeypatch, fault, fails):
    scenes, _ = units
    k = faults_series.SERIES.index(fault) + 1
    # the series' first two dates, the sound series' keypoints in the
    # unit's cache, which the run keeps, and the first date's gauge held by
    # its first camera (fix_ref_cam: a few LM iterations, not ~500)
    shutil.copytree(os.path.join(scenes.work, "series0", "ba_sequential", "matches", "features"),
                    os.path.join(scenes.work, "series{}".format(k), "ba_sequential", "matches",
                                 "features"))
    cli = dict(scenes.config["cli"], reset=False, timeline_indices=[0, 1], fix_ref_cam=True)
    monkeypatch.setattr(scenes, "config", dict(scenes.config, cli=cli))
    monkeypatch.setattr(scenes, "dates", scenes.dates[:2])
    getattr(faults_series, fault)(monkeypatch)
    rec = scenes(k)
    numbers = cell["driver"].check(scenes, [rec])[0]
    failed = _failed(numbers, cell["limits"])
    assert failed, numbers
    if fails:
        assert fails in failed, numbers


def _counts(cached, detected, pairs_cached, pairs_matched):
    return {"features_cached": cached, "features_detected": detected,
            "pairs_cached": pairs_cached, "pairs_matched": pairs_matched}


@pytest.mark.parametrize("counts,value", [
    ([_counts(0, 4, 0, 6)] + [_counts(4, 4, 6, 22)] * 4, 0),  # sound
    ([_counts(0, 4, 0, 6)] + [_counts(0, 8, 6, 22)] * 4, 16),  # keypoints
    ([_counts(0, 4, 0, 6), _counts(4, 4, 0, 28)], 6),  # the frozen pairs
    ([_counts(0, 4, 0, 6)] + [_counts(0, 4, 0, 6)] * 2, 0),  # n_dates 0
    ([_counts(4, 0, 6, 0), _counts(8, 0, 6, 22)], 0),  # every keypoint from the cache
    (None, 0),  # a program that keeps no counts
])
def test_recomputed_counts_the_caches_computed_again(counts, value):
    stats = {} if counts is None else {"ft_counts": counts}
    assert ts_scenes.recomputed({"date_stats": stats}, 4) == value


@pytest.mark.parametrize("metric", ["cli.load_s", "tracks.detection_s", "tracks.matching_s",
                                    "pipeline.ba_s.scene", "pipeline.refit_s"])
def test_the_cli_cells_readers_read_a_series_record(units, metric):
    """The record carries the dates' stage walls summed, as a CLI run's."""
    _, rec = units
    stats = rec["date_stats"]
    assert rec["ft_timing"]["detection_s"] == pytest.approx(
        sum(t["detection_s"] for t in stats["ft_timing"]))
    assert rec["timing"]["l2_s"] == pytest.approx(sum(t["l2_s"] for t in stats["timing"]))
    value = specm.Spec().reader(metric)({"units": [rec], "trace": None})
    assert value is not None and value > 0, value


def _shifted(rpc, dlon=0.0, dlat=0.0, dalt=0.0):
    """The RPC of the ground moved by (dlon, dlat, dalt)."""
    return dict(rpc, lon_offset=rpc["lon_offset"] + dlon, lat_offset=rpc["lat_offset"] + dlat,
                alt_offset=rpc["alt_offset"] + dalt)


@pytest.mark.parametrize("moved", ["every_view", "one_date"])
def test_series_bias_takes_out_a_common_shift_and_sees_one_date(moved):
    """On the tiny series' rendered RPCs: one ground shift of every view
    leaves nothing; the same shift of one date alone leaves its size."""
    dates, per_date, h, w, alt = 3, 3, 400, 400, 50.0
    n_ring = dates * per_date
    true = [series.ring_rpc(i, n_ring, h, w) for i in range(n_ring)]
    shift = dict(dlon=2e-5, dlat=-1.5e-5, dalt=4.0)  # ~2 px, ~1.5 px and parallax
    adj = [_shifted(r, **shift) if moved == "every_view" or i // per_date == 1 else r
           for i, r in enumerate(true)]
    gap = cli_outputs.bias([cli_outputs._rpc(r) for r in adj],
                           [cli_outputs._rpc(r) for r in true], h, w, alt)
    if moved == "every_view":
        assert gap < 1e-6, gap
    else:
        assert gap > 0.5, gap


def test_a_date_unchanged_is_render_views_view():
    """With no change of the ground, a view of the series is the view of
    `generate.render_views` at its ring position, bit for bit."""
    none = {"weight": 0.0, "texture_seed": 1, "gain": [1.0] * 2, "offset": [0.0] * 2}
    frames, rpcs = series.render_series(2, 2, 48, 64, 50.0, 64, 3, 0, none, CPU)
    ring, ring_rpcs = generate.render_views(4, 48, 64, 50.0, 64, 3, 0, CPU)
    for d in range(2):
        for k in range(2):
            i = series.ring_position(d, k, 2)
            assert (frames[d][k] == ring[i]).all()
            assert all((rpcs[d][k][f] == ring_rpcs[i][f]).all() for f in ("samp_num", "line_num"))
    changed = dict(none, weight=0.3)
    assert (series.render_series(2, 2, 48, 64, 50.0, 64, 3, 0, changed, CPU)[0][1][0]
            != frames[1][0]).any()


def test_the_reference_and_the_series_load_nothing_of_the_port_or_of_jax():
    code = ("import portbench.reference.ts_outputs, portbench.scenes.series\n"
            "import portbench.faults_series, sys, json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=specm.ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=specm.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert not loaded & (set(runm.FORBIDDEN) | {"sat_bundleadjust_tpu_torch"}), loaded


# a traced series (ns): three dates, the device busy [100, 200], [450, 500],
# [800, 850]; the second and third dates read the caches
SERIES_OPS = [("k1", 100, 200), ("k2", 450, 500), ("k3", 800, 850)]
SERIES_SPANS = [
    (1, None, "cli.main", 0, 1000, {}),
    (2, 1, "ts.date", 0, 300, {"date": 0}),
    (3, 2, "detection.cache_read", 10, 20, {}),
    (4, 1, "ts.date", 300, 600, {"date": 1}),
    (5, 4, "detection.cache_read", 310, 330, {}),
    (6, 4, "matching.cache_read", 340, 350, {}),
    (7, 4, "pipeline.pts3d_fix", 360, 400, {"tracks": 10}),
    (8, 1, "ts.date", 600, 1000, {"date": 2}),
    (9, 8, "matching.cache_read", 610, 640, {}),
]


@pytest.mark.parametrize("metric,value", [
    ("ts.date_s", 350e-9),  # (300 + 400) / 2 dates
    ("ts.cache_read_s", 50e-9),  # (20 + 10 + 40 + 30) / 2 dates
])
def test_the_series_readers_by_hand(monkeypatch, metric, value):
    from sat_bundleadjust_tpu_torch.utils import profiling

    run = {"units": [{"traced": True}],
           "trace": {"busy_s": 0.0, "window_s": 1.0, "device_ops": SERIES_OPS}}
    read = specm.Spec().reader(metric)
    monkeypatch.setattr(profiling, "spans", lambda: list(SERIES_SPANS))
    assert read(run) == pytest.approx(value)
    # a series of one date, and a program that keeps no spans, give no value
    monkeypatch.setattr(profiling, "spans", lambda: list(SERIES_SPANS[:3]))
    assert read(run) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(run) is None
