"""The port's span recorder (sat_bundleadjust_tpu_torch/utils/profiling.py)
on the CPU: nothing is kept and no profiler range is opened while no
profiler records; under a profiler the spans nest, sit on the clock of the
profiler's own events, keep their counters, and garbage collections become
spans; the timing dicts get the walls they got before."""

import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sat_bundleadjust_tpu_torch.utils import profiling
from sat_bundleadjust_tpu_torch.utils.profiling import span


@pytest.fixture
def recorder():
    """A clean span list, after one profiled range: the first profiler
    range of a process pays the profiler's start-up on its thread (~1 ms)."""
    with profile(activities=[ProfilerActivity.CPU]):
        with span("warm"):
            pass
    profiling.reset()
    yield
    profiling.reset()


def _names(spans):
    return [s[2] for s in spans]


def test_untraced_spans_keep_nothing_and_open_no_range(recorder, monkeypatch):
    def no_range(name):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(profiling, "record_function", no_range)
    timing = {}
    with span("outer", timing, "outer_s", frames=3) as outer:
        with span("inner"):
            torch.ones(4).sum()
    gc.collect()
    assert profiling.spans() == []
    assert outer.seconds >= 0 and timing == {"outer_s": outer.seconds}


def test_traced_spans_nest_with_their_parents(recorder):
    with profile(activities=[ProfilerActivity.CPU]):
        with span("a", k=1):
            with span("b"):
                with span("c"):
                    pass
            with span("d"):
                pass
        with span("e"):
            pass
    got = {s[2]: s for s in profiling.spans()}
    assert sorted(got) == ["a", "b", "c", "d", "e"]
    parent = {name: s[1] for name, s in got.items()}
    ids = {name: s[0] for name, s in got.items()}
    assert parent == {"a": None, "b": ids["a"], "c": ids["b"], "d": ids["a"], "e": None}
    assert got["a"][5] == {"k": 1}
    for name, (_, _, _, start, end, _) in got.items():
        assert start <= end
        if parent[name] is not None:
            p = [s for s in got.values() if s[0] == parent[name]][0]
            assert p[3] <= start and end <= p[4]
    profiling.reset()
    assert profiling.spans() == []


def test_span_stamps_lie_on_the_profilers_clock(recorder):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with span("step{}".format(i)):
                torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    events = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("step")}
    spans = profiling.spans()
    assert len(spans) == 5
    for _, _, name, start, end, _ in spans:
        ev_start, ev_end = events[name]
        assert abs(start - ev_start) < 250_000, (name, start - ev_start)
        assert abs(end - ev_end) < 250_000, (name, end - ev_end)


def test_timing_keys_get_the_walls_as_before(recorder):
    timing = {"kept_s": 1.0}
    with span("first", timing, "fresh_s") as first:
        pass
    with span("summed", timing, "kept_s") as summed:
        pass
    with span("again", timing, "kept_s") as again:
        pass
    assert timing["fresh_s"] == first.seconds
    assert timing["kept_s"] == pytest.approx(1.0 + summed.seconds + again.seconds)
    with span("none") as plain:
        pass
    assert plain.seconds >= 0


def test_a_collection_under_the_profiler_is_a_span(recorder):
    gc.collect()  # untraced: kept nowhere
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("outer"):
            gc.collect()
    spans = profiling.spans()
    outer = [s for s in spans if s[2] == "outer"][0]
    collections = [s for s in spans if s[2] == "python.gc"]
    assert collections and all(s[5]["generation"] == 2 and s[1] == outer[0]
                               for s in collections)
    assert all(outer[3] <= s[3] <= s[4] <= outer[4] for s in collections)


def test_the_lm_solve_keeps_its_host_reads_per_span(recorder):
    """A small BA stage under the profiler: the layer's spans, and the
    solve's counters as its span's attributes."""
    from sat_bundleadjust_tpu_torch.ba.params import BAParams
    from sat_bundleadjust_tpu_torch.ba.solver import BASolver
    from sat_bundleadjust_tpu_torch.utils import demo

    data = demo.make_scene_arrays(n_cam=6, n_pts=200, obs_per_pt=3, seed=3, device="cpu")
    pts0 = data["pts3d"] + 1.0
    args = (data["pts_ind"], data["cam_ind"], data["pts2d"], pts0, data["rpc_list"], "rpc",
            list(data["camera_centers"]), [], {"verbose": False})
    with profile(activities=[ProfilerActivity.CPU]):
        p = BAParams.from_obs_table(*args)
        solver = BASolver(p, schur_mode="cg", device="cpu")
        _, (cam, pts), _, _, info = solver.solve(None)
        p.reconstruct_vars(cam, pts, p.pts3d, p.cameras)
    spans = profiling.spans()
    names = set(_names(spans))
    assert {"ba.params", "ba.params.sort", "ba.params.cameras", "ba.params.stack_rpcs",
            "ba.solver.init", "ba.upload", "ba.make_fns", "ba.build_problem", "ba.solve",
            "lm.solve", "lm.cg_read", "lm.result_read", "ba.reconstruct",
            "ba.reconstruct.points"} <= names
    init = [s for s in spans if s[2] == "ba.solver.init"][0]
    assert init[5] == {"tables_on": "cpu", "h2d_bytes": 0}
    solve = [s for s in spans if s[2] == "lm.solve"][0]
    assert solve[5]["host_syncs"] == info["host_syncs"] > 0
    assert solve[5]["iterations"] == info["iterations"]
    assert solve[5]["cg_iterations"] == info["cg_iterations"]
    reads = [s for s in spans if s[2] in ("lm.cg_read", "lm.stop_read")]
    assert len(reads) == info["host_syncs"] and all(s[1] is not None for s in reads)
    by_id = {s[0]: s for s in spans}
    assert by_id[solve[1]][2] == "ba.solve"


def test_the_front_end_and_refit_spans_carry_their_counts(recorder):
    """SIFT on two small frames, a triangulation and an RPC refit under the
    profiler: frames, host reads and IRLS syncs as span attributes."""
    from sat_bundleadjust_tpu_torch.ba import rpcfit
    from sat_bundleadjust_tpu_torch.ops.sift import detect_sift_batch
    from sat_bundleadjust_tpu_torch.ops.triangulate import init_pts3d
    from sat_bundleadjust_tpu_torch.utils import demo

    rng = np.random.default_rng(0)
    frames = [rng.random((96, 96)).astype(np.float32) for _ in range(2)]
    data = demo.make_scene_arrays(n_cam=3, n_pts=50, obs_per_pt=3, seed=1, device="cpu")
    C = np.full((6, 50), np.nan)
    for k, (pt, cam) in enumerate(zip(data["pts_ind"], data["cam_ind"])):
        C[2 * cam: 2 * cam + 2, pt] = data["pts2d"][k]
    rt = np.concatenate([np.zeros(6), data["camera_centers"][0]])
    refit = {}
    with profile(activities=[ProfilerActivity.CPU]):
        detect_sift_batch(frames, device="cpu", batch_chunk=2)
        init_pts3d(C, data["rpc_list"], "rpc", [(0, 1), (1, 2)], device="cpu")
        rpcfit.fit_rpcs_batched([rt], None, data["rpc_list"][:1],
                                [{"col0": 0, "row0": 0, "width": 1000, "height": 1000}],
                                [data["pts3d"]], device="cpu", stats=refit)
    spans = profiling.spans()
    batch = [s for s in spans if s[2] == "sift.batch"]
    assert len(batch) == 1 and batch[0][5] == {"frames": 2}
    children = {s[2] for s in spans if s[1] == batch[0][0]}
    assert {"sift.upload", "sift.pyramid", "sift.describe", "sift.to_host"} <= children
    # the CPU takes the plain blurs: no kernel launch in the pyramid
    assert [s[5] for s in spans if s[2] == "sift.pyramid"] == [{"blur_launches": 0}]
    tri = [s for s in spans if s[2] == "triangulate.rpc"]
    assert tri and all(s[5]["host_reads"] >= 1 for s in tri)
    loop = [s for s in spans if s[2] == "triangulate.loop"][0]
    assert all(s[1] == loop[0] for s in tri) and loop[5]["chunks"] == 1
    irls = [s for s in spans if s[2] == "rpcfit.irls"]
    # the refit's own count adds one read a margin round to the IRLS's
    assert sum(s[5]["host_syncs"] for s in irls) == refit["host_syncs"] - refit["rounds"] > 0


def test_the_table_triangulation_on_the_cpu_takes_the_plain_route(recorder, monkeypatch):
    """triangulate_table on the CPU under the profiler: the plain version in
    SATBA_TRIANG_CHUNK chunks, one `triangulate.rpc` span a chunk on the
    route "plain" with its reads of the device, no kernel launch; the
    launch counters list the RPC triangulation's wrapper."""
    from sat_bundleadjust_tpu_torch.ops import launches
    from sat_bundleadjust_tpu_torch.ops import triangulate as ttri
    from sat_bundleadjust_tpu_torch.utils import demo

    assert ttri.rpc_triangulate in launches.WRAPPERS
    scene = demo.make_scene_arrays(n_cam=4, n_pts=60, obs_per_pt=3, seed=1, device="cpu")
    order = np.lexsort((scene["cam_ind"], scene["pts_ind"]))
    table = [torch.as_tensor(scene[k][order]) for k in ("pts_ind", "cam_ind", "pts2d")]
    monkeypatch.setenv("SATBA_TRIANG_CHUNK", "50")
    before = launches.snapshot()
    reads = {}
    with profile(activities=[ProfilerActivity.CPU]):
        _, n_duos = ttri.triangulate_table(*table, 60, 4, scene["rpc_list"], "rpc",
                                           [(0, 1), (1, 2), (2, 3)], reads=reads)
    spans = profiling.spans()
    assert launches.snapshot() == before and n_duos > 50
    loop = [s for s in spans if s[2] == "triangulate.loop"]
    tri = [s for s in spans if s[2] == "triangulate.rpc"]
    assert len(loop) == 1 and loop[0][5]["chunks"] == len(tri) == -(-n_duos // 50)
    assert all(s[5]["route"] == "plain" and s[5]["host_reads"] >= 1 for s in tri)
    assert sum(s[5]["duos"] for s in tri) == n_duos and reads["host_reads"] > len(tri)


def test_the_command_line_traces_its_run_with_the_spans(recorder, tmp_path, monkeypatch):
    """With SATBA_PROFILE_DIR set, `cli.main` writes one Chrome trace of the
    run, which holds its spans as the profiler's ranges (the scene stubbed:
    a span and one operator)."""
    import glob
    import json

    import sat_bundleadjust_tpu_torch as pkg
    from sat_bundleadjust_tpu_torch import cli, timeseries

    class Scene:
        def __init__(self, config, device=None):
            self.device = device

        def run_bundle_adjustment_for_RPC_refinement(self):
            with span("scene.stub"):
                torch.mm(torch.ones(16, 16), torch.ones(16, 16))

    monkeypatch.setattr(timeseries, "Scene", Scene)
    monkeypatch.setattr(pkg, "resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setenv("SATBA_PROFILE_DIR", str(tmp_path / "traces"))
    config = tmp_path / "scene.json"
    config.write_text(json.dumps({"output_dir": str(tmp_path / "out")}))
    cli.main([str(config)])
    files = glob.glob(str(tmp_path / "traces" / "cli" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"cli.main", "scene.stub", "aten::mm"} <= names
    assert [s[2] for s in profiling.spans()] == ["scene.stub", "cli.main"]


def test_a_sequential_series_keeps_one_date_span_a_date(recorder, tmp_path):
    """A series of 2 dates of 2 views in `ba_sequential` under the profiler:
    one `ts.date` span a date with its attributes; the cache counters add
    up to the date's views and pairs, the second date reads the first's
    keypoints and pair from the caches, inside its span."""
    from PIL import Image

    from portbench.scenes import generate, series
    from portbench.scenes import rpc as rpcm
    from sat_bundleadjust_tpu_torch.timeseries import Scene

    change = {"weight": 0.1, "texture_seed": 1, "gain": [1.0, 0.9], "offset": [0.0, 12.0]}
    frames, rpcs = series.render_series(2, 2, 200, 200, 50.0, 256, 4, 0, change, "cpu")
    names = series.names(2, 2, 7, 90)
    bias = generate.biases(4, 3.0, 5)
    img = tmp_path / "images"
    img.mkdir()
    for d in range(2):
        for k in range(2):
            Image.fromarray(frames[d][k]).save(str(img / (names[d][k] + ".tif")))
            b = bias[2 * d + k]
            rpcm.write_file(dict(rpcs[d][k], col_offset=rpcs[d][k]["col_offset"] + b[0],
                                 row_offset=rpcs[d][k]["row_offset"] + b[1]),
                            str(img / (names[d][k] + ".rpc")))
    cfg = {"geotiff_dir": str(img), "rpc_dir": str(img), "rpc_src": "txt", "cam_model": "rpc",
           "output_dir": str(tmp_path / "out"), "ba_method": "ba_sequential", "n_dates": 1,
           "FT_kp_max": 1500, "FT_save": True, "save_figures": False}
    with profile(activities=[ProfilerActivity.CPU]):
        scene = Scene(cfg, device="cpu")
        scene.run_bundle_adjustment_for_RPC_refinement()
    spans = profiling.spans()
    dates = sorted((s for s in spans if s[2] == "ts.date"), key=lambda s: s[3])
    assert [s[5]["date"] for s in dates] == [0, 1]
    assert [s[5]["date_id"] for s in dates] == [n[0][:15] for n in names]
    first, second = (s[5] for s in dates)
    assert (first["n_adj"], first["n_new"], first["cams_fixed"]) == (0, 2, 0)
    assert (second["n_adj"], second["n_new"], second["cams_fixed"]) == (2, 2, 2)
    pairs = np.load(str(tmp_path / "out" / "ba_sequential" / "matches" / "pairs_matching.npy"))
    for attrs, views in ((first, 2), (second, 4)):
        assert attrs["features_cached"] + attrs["features_detected"] == views
        assert attrs["pairs_cached"] + attrs["pairs_matched"] <= views * (views - 1) // 2
    assert second["pairs_cached"] + second["pairs_matched"] == len(pairs)
    assert (first["features_cached"], first["pairs_cached"]) == (0, 0)
    assert (second["features_cached"], second["pairs_cached"]) == (2, 1)
    assert scene.date_stats["ft_counts"] == [
        {k: a[k] for k in ("features_cached", "features_detected", "pairs_cached",
                           "pairs_matched")} for a in (first, second)]

    def inside(name):
        return [s for s in spans if s[2] == name and dates[1][3] <= s[3] and s[4] <= dates[1][4]]

    assert len(inside("detection.cache_read")) == len(inside("matching.cache_read")) == 1
    fixed = inside("pipeline.pts3d_fix")
    assert [s[5]["tracks"] for s in fixed] == ([second["pts_fixed"]] if second["pts_fixed"] else [])
    assert all(s[4] - s[3] > 0 for s in dates)
    assert scene.date_stats["date_s"][1] >= scene.date_stats["time"][1]
