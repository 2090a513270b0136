"""The span metrics' arithmetic (portbench/spans.py and the five readers in
portbench/metrics/) on hand-built windows of program spans and device
operations, each against its value worked by hand; and a run of a program
that keeps no spans, which gives no value."""

import pytest

from portbench import spans as spansm
from portbench import spec as specm
from sat_bundleadjust_tpu_torch.utils import profiling

# a traced CLI scene (ns): the union of the device's operations is
# [100, 300], [310, 315], [500, 600], [700, 710], [900, 1000]: 415 busy
SCENE_OPS = [("k1", 100, 200), ("k2", 150, 300), ("k0", 310, 315), ("k3", 500, 600),
             ("k4", 700, 710), ("k5", 900, 1000)]
SCENE_SPANS = [
    (1, None, "cli.main", 50, 1050, {}),
    (2, 1, "tracks.detection", 50, 650, {}),
    (3, 2, "sift.batch", 90, 320, {"frames": 2}),
    (4, 2, "detection.write", 320, 480, {}),
    (5, 1, "tracks.matching", 660, 1050, {}),
    (6, 5, "python.gc", 720, 800, {"generation": 0}),
]
# two traced BA stages and an untraced one: the union is [60, 100],
# [150, 250], [400, 600], [950, 1000]; the first stage's parameters are
# made on the host alone, before the window's first device operation
STAGE_OPS = [("a", 60, 100), ("b", 150, 250), ("c", 400, 600), ("d", 950, 1000)]
STAGE_SPANS = [
    (1, None, "ba.params", 0, 50, {}),
    (2, None, "ba.solver.init", 50, 140, {}),
    (3, None, "lm.solve", 140, 500, {"host_syncs": 3}),
    (4, 3, "lm.cg_read", 260, 270, {}),
    (5, None, "ba.reconstruct", 500, 700, {}),
    (6, None, "ba.params", 700, 760, {}),
    (7, None, "ba.solver.init", 760, 800, {}),
    (8, None, "lm.solve", 800, 1000, {}),
    (9, None, "ba.reconstruct", 990, 1100, {}),
]


def _run(ops, units, window_s=1.0):
    return {"units": units, "trace": {"busy_s": 0.0, "window_s": window_s, "device_ops": ops}}


def kept(monkeypatch, spans):
    """The program's recorder, as if it had kept `spans`."""
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))


@pytest.fixture
def scene(monkeypatch):
    kept(monkeypatch, SCENE_SPANS)
    return _run(SCENE_OPS, [{"ft_timing": {}, "traced": True}])


@pytest.fixture
def stage(monkeypatch):
    kept(monkeypatch, STAGE_SPANS)
    return _run(STAGE_OPS, [{"shapes": [], "traced": True}, {"shapes": [], "traced": True},
                            {"shapes": [], "traced": False}])


def read(metric, run):
    return specm.Spec().reader(metric)(run)


def test_busy_time_inside_an_interval():
    busy = spansm.Busy(SCENE_OPS)
    assert busy.total == 415 and (busy.lo, busy.hi) == (100, 1000)
    assert busy.busy(50, 650) == 305 and busy.idle(50, 650) == 295
    assert busy.busy(150, 312) == 152 and busy.busy(0, 2000) == 415
    assert busy.idle(600, 700) == 100 and busy.busy(1000, 1050) == 0


def test_the_scene_readers_by_hand(scene):
    # detection [50, 650]: 305 busy of 600
    assert read("tracks.detection.idle_share", scene) == pytest.approx(100 * 295 / 600)
    # matching [660, 1050]: 110 busy of 390
    assert read("tracks.matching.idle_share", scene) == pytest.approx(100 * 280 / 390)
    # k1, k2 and k0 start in the SIFT batch of 2 frames
    assert read("sift.device_ops_per_frame", scene) == pytest.approx(1.5)


def test_the_stage_readers_by_hand(stage):
    # the solves: [140, 500] 200 busy of 360, [800, 1000] 50 busy of 200
    assert read("lm.solve.idle_share", stage) == pytest.approx(100 * 310 / 560)
    # 50 + 90 + 200 + 60 + 40 + 110 ns over the 2 traced stages: the first
    # ba.params [0, 50] ends before the first device operation and counts
    assert read("ba.host_phases_s", stage) == pytest.approx(550e-9 / 2)


def test_idle_time_by_the_innermost_span_and_its_cover():
    busy = spansm.Busy(SCENE_OPS)
    got = spansm.idle_by_innermost(SCENE_SPANS, busy)
    want = {"cli.main": 10, "tracks.detection": 110, "sift.batch": 25, "detection.write": 160,
            "tracks.matching": 200, "python.gc": 80, "(no span)": 0}
    assert got == pytest.approx({k: v * 1e-9 for k, v in want.items()})
    assert sum(got.values()) == pytest.approx(585e-9)  # [50, 1050] less 415 busy
    # the root's own 10 ns ([650, 660]) are the only idle time outside the
    # spans below it
    assert spansm.covered_share(SCENE_SPANS, busy) == pytest.approx(100 * 575 / 585)
    # no root: the stage's spans cover the whole window
    assert spansm.covered_share(STAGE_SPANS, spansm.Busy(STAGE_OPS)) == pytest.approx(100.0)


def test_spans_of_an_earlier_traced_window_are_left_out(monkeypatch):
    # a window of 1 050 ns that ends at the last operation (1 000 ns) began
    # at -50 ns at the earliest; the clocks' margin takes 100 ms off that
    earlier = [(20, None, "ba.params", -300_000_000, -200_000_000, {}),
               (21, None, "lm.solve", -200_000_000, -150_000_000, {})]
    kept(monkeypatch, earlier + SCENE_SPANS + [(7, None, "host.only", -100_000_000, 30, {})])
    run = _run(SCENE_OPS, [], window_s=1050e-9)
    got = [s[2] for s in spansm.recorded(run)]
    assert got == [s[2] for s in SCENE_SPANS] + ["host.only"]


NAMES = ("tracks.detection.idle_share", "sift.device_ops_per_frame",
         "tracks.matching.idle_share", "lm.solve.idle_share", "ba.host_phases_s")


@pytest.mark.parametrize("cell", ["scene", "stage"])
def test_a_program_without_spans_gives_no_value(request, monkeypatch, cell):
    run = request.getfixturevalue(cell)
    monkeypatch.delattr(profiling, "spans")  # the parent's program keeps none
    for name in NAMES:
        assert read(name, run) is None


def test_a_run_without_spans_or_trace_gives_no_value(monkeypatch):
    kept(monkeypatch, [])
    for name in NAMES:
        assert read(name, _run(SCENE_OPS, [{"traced": True}])) is None
        assert read(name, {"units": [], "trace": None}) is None
