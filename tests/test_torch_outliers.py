"""The outlier pass on the observation table (ba/outliers.rm_outliers) and
the table's triangulation duos (ops/triangulate.py), port against the JAX
package's dense C path on the CPU (the port holds no C); the robust BA stage (soft-L1, outliers,
L2) of a table-built problem; and the port's stage against the benchmark's
plain reference (portbench/reference/ba_clean.py) at a small size."""

import json
import os
import tracemalloc

import numpy as np
import pytest
import torch

from test_torch_common import both_problems, jax_scene

from sat_bundleadjust_tpu.ba import outliers as jout
from sat_bundleadjust_tpu.ops import triangulate as jtri

from sat_bundleadjust_tpu_torch.ba import outliers as tout
from sat_bundleadjust_tpu_torch.ba.params import BAParams
from sat_bundleadjust_tpu_torch.ba.solver import SOFT_L1_ROUND, BASolver
from sat_bundleadjust_tpu_torch.ops import triangulate as ttri
from sat_bundleadjust_tpu_torch.utils import demo

CPU = torch.device("cpu")


def ring(n_cam, distances):
    return [(i, (i + d) % n_cam) for d in distances for i in range(n_cam)]


def synthetic_errors(n, seed, share=0.03, dtype=np.float32):
    """Per-observation errors as a solve leaves them: most below 1 px, a
    share of them 10-30 px."""
    rng = np.random.RandomState(seed)
    err = np.abs(rng.randn(n)) * 0.3 + (rng.rand(n) < share) * rng.uniform(10, 30, n)
    return err.astype(dtype)


CASES = {
    # name: (scene kwargs, pairs, constructor options, rm_outliers options, error share)
    "all_pairs": ({"n_cam": 8, "n_pts": 600, "seed": 3}, None, {}, {}, 0.03),
    "ring2_drops_tracks": ({"n_cam": 10, "n_pts": 800, "seed": 4}, "ring2", {}, {}, 0.15),
    "tracks_left_with_one": ({"n_cam": 8, "n_pts": 600, "seed": 5, "obs_per_pt": 2}, None, {},
                             {}, 0.2),
    "n_pts_fix": ({"n_cam": 8, "n_pts": 600, "seed": 6, "obs_per_pt": 3}, None,
                  {"n_pts_fix": 100}, {}, 0.15),
    "predef_thr": ({"n_cam": 8, "n_pts": 600, "seed": 7}, None, {}, {"predef_thr": 0.6}, 0.03),
    "reference_rounding": ({"n_cam": 8, "n_pts": 600, "seed": 8}, None, {},
                           {"reference_rounding": True}, 0.03),
}


def _problems(case, table=False):
    scene_kw, pairs, d, _, _ = CASES[case]
    scene = jax_scene(**scene_kw)
    jp, tp = both_problems(scene, dense_c=True, d=d)
    if pairs == "ring2":
        pairs = ring(jp.n_cam, [2])
        jp.pairs_to_triangulate = tp.pairs_to_triangulate = pairs
    if table:
        tp = BAParams.from_obs_table(tp.pts_ind, tp.cam_ind, tp.pts2d, tp.pts3d, tp.cameras,
                                     "rpc", tp.camera_centers, tp.pairs_to_triangulate,
                                     dict(d, verbose=False))
    return jp, tp


@pytest.mark.parametrize("table", [False, True], ids=["from_C", "from_table"])
@pytest.mark.parametrize("case", list(CASES))
def test_table_pass_matches_jax(case, table):
    """The same errors through JAX's dense C path and the port's table pass:
    the kept table, pts_prev_indices, n_pts_fix and the re-triangulated
    points (within 1e-4 m); the port's problem, built from C or from a
    table, holds the table and no C."""
    jp, tp = _problems(case, table)
    kw, share = CASES[case][3], CASES[case][4]
    err = synthetic_errors(jp.n_obs, seed=len(case), share=share)
    jp2 = jout.rm_outliers(err, jp, **kw)
    tp2 = tout.rm_outliers(err, tp, device="cpu", **kw)
    assert jp2 is not jp and tp2 is not tp
    for name in ("pts_ind", "cam_ind", "pts2d", "pts_prev_indices", "pts2d_w", "cam_params"):
        np.testing.assert_array_equal(getattr(tp2, name), getattr(jp2, name), err_msg=name)
    for name in ("n_pts_fix", "n_cam_fix", "n_pts", "n_cam", "n_obs", "n_params"):
        assert getattr(tp2, name) == getattr(jp2, name), name
    np.testing.assert_array_equal(tp2.pts_opt_mask, jp2.pts_opt_mask)
    assert not hasattr(tp, "C") and not hasattr(tp2, "C")
    for q in (tp, tp2):  # no (2M, N) array: the table is the only copy
        assert not any(getattr(v, "shape", None) == (2 * q.n_cam, q.n_pts)
                       for v in vars(q).values())
    assert np.sum(~np.isnan(jp2.C)) == 2 * tp2.n_obs
    np.testing.assert_allclose(tp2.pts3d, jp2.pts3d, rtol=0, atol=1e-4)
    if case == "ring2_drops_tracks":  # the pairs drop tracks of >= 2 observations
        C_left = jout.compute_obs_to_remove(err, jp, **kw)[0]
        assert jp2.n_pts < np.sum(np.sum(~np.isnan(C_left[::2]), axis=0) >= 2) - 10
    if case == "tracks_left_with_one":
        assert jp2.n_pts < jp.n_pts - 50  # tracks of one observation dropped
    if case == "n_pts_fix":
        assert 0 < jp2.n_pts_fix < 100


@pytest.mark.parametrize("pairs", ["all", "ring2", "reversed_and_repeated", "out_of_range",
                                   "self_pair", "none"])
def test_table_duos_equal_the_c_batch_as_a_set(pairs):
    """observation_duos on the table gives the JAX package's
    build_triangulation_batch's duos on the dense C, as a multiset of
    (cam_a, cam_b, track, pts_a, pts_b); tracks_with_a_pair gives its
    filter_C_using_pairs_to_triangulate's tracks."""
    scene = jax_scene(n_cam=7, n_pts=300, seed=9, obs_per_pt=4)
    jp, tp = both_problems(scene, dense_c=True)
    M = tp.n_cam
    listed = {
        "all": tp.pairs_to_triangulate,
        "ring2": ring(M, [2]),
        "reversed_and_repeated": [(1, 0), (0, 1), (2, 3), (2, 3), (5, 3), (6, 0)],
        "out_of_range": [(0, 1), (1, 7), (9, 2), (3, 4)],
        "self_pair": [(2, 2), (0, 1)],
        "none": [],
    }[pairs]
    ref = jtri.build_triangulation_batch(jp.C, listed)
    pts, cam = torch.as_tensor(tp.pts_ind).long(), torch.as_tensor(tp.cam_ind).long()
    a, b = ttri.observation_duos(pts, cam, tp.n_pts, M, ttri.pair_lookup(listed, M, CPU))
    got = sorted(zip(tp.cam_ind[a.numpy()].tolist(), tp.cam_ind[b.numpy()].tolist(),
                     tp.pts_ind[a.numpy()].tolist(), map(tuple, tp.pts2d[a.numpy()].tolist()),
                     map(tuple, tp.pts2d[b.numpy()].tolist())))
    if ref is None:
        assert got == []
        return
    want = sorted(zip(ref["cam_a"].tolist(), ref["cam_b"].tolist(), ref["track"].tolist(),
                      map(tuple, ref["pts_a"].tolist()), map(tuple, ref["pts_b"].tolist())))
    assert got == want and len(got) > 0
    keep = ttri.tracks_with_a_pair(pts, cam, tp.n_pts, M, ttri.pair_lookup(listed, M, CPU))
    np.testing.assert_array_equal(np.nonzero(keep.numpy())[0],
                                  jout.filter_C_using_pairs_to_triangulate(jp.C, listed))


def test_segment_mean_adds_in_order():
    """The per-track mean sums each segment's values in their order, the
    same as a loop, and gives zeros to an empty segment."""
    rng = np.random.RandomState(0)
    seg = np.sort(rng.randint(0, 50, 400))
    seg = seg[seg != 7]
    vals = rng.randn(len(seg), 3) * 1e6 + rng.randn(len(seg), 3)
    got = ttri.segment_mean(torch.as_tensor(vals), torch.as_tensor(seg), 50).numpy()
    for s in range(50):
        acc = np.zeros(3)
        for v in vals[seg == s]:
            acc = acc + v
        np.testing.assert_array_equal(got[s], acc / max(np.sum(seg == s), 1))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_camera_thresholds_match_the_numpy_rule(dtype):
    """camera_thresholds, every camera at once, against get_elbow_value's
    rule camera by camera (numpy's percentile in the errors' dtype),
    cameras of 0, 1, 2 and many observations included."""
    rng = np.random.RandomState(1)
    for trial in range(40):
        M = rng.randint(1, 12)
        cam = rng.randint(0, M, rng.randint(1, 500))
        cam[: min(len(cam), 3)] = [M - 1] * min(len(cam), 3)
        err = synthetic_errors(len(cam), trial, share=rng.uniform(0, 0.2), dtype=dtype)
        err *= rng.uniform(0.1, 5)
        want = []
        for c in range(M):
            sel = err[cam == c]
            if len(sel) == 0:
                want.append(np.inf)
                continue
            elbow, ok = jout.get_elbow_value(sel)
            want.append(max(elbow, 1.0) if ok else float(np.max(sel)))
        got = tout.camera_thresholds(torch.as_tensor(err), torch.as_tensor(cam).long(), M)
        np.testing.assert_array_equal(got.numpy(), np.array(want))


def test_per_duo_stop_gives_the_frozen_mask_loops_h():
    """The RPC kernel's schedule, each duo stopping on its own once |lam| <
    1e-5 after that step (test_torch_cuda.per_duo_search, on the plain
    arithmetic), gives rpc_triangulation's points and residuals bit for bit
    on a batch of curved RPCs whose duos converge after 2 to 5 steps."""
    from test_torch_cuda import per_duo_search, ring_rpcs, rpc_duos

    from sat_bundleadjust_tpu_torch.models import ellipsoid
    from sat_bundleadjust_tpu_torch.models.rpc import index_rpc, stack_rpcs

    rpcs = stack_rpcs(ring_rpcs(24, curvature=6e-3, seed=3), "cpu")
    ca, cb, pa, pb = rpc_duos(rpcs, 2000, seed=4)
    out = per_duo_search(rpcs, ca, cb, pa, pb)
    assert len(out[4].unique()) >= 3
    pts3d, err = ttri.rpc_triangulation(index_rpc(rpcs, ca), index_rpc(rpcs, cb), pa, pb)
    assert torch.equal(ellipsoid.latlon_to_ecef_arr(out[1], out[0], out[2]), pts3d)
    assert torch.equal(out[3], err)


def test_rpc_triangulate_takes_the_plain_version_on_the_cpu_only(monkeypatch):
    """rpc_triangulate on CPU tensors: the plain version in chunks of
    SATBA_TRIANG_CHUNK, equal to one rpc_triangulation over the batch, and
    no kernel launch; on another device (not CUDA) it raises."""
    from test_torch_cuda import ring_rpcs, rpc_duos

    from sat_bundleadjust_tpu_torch.models.rpc import index_rpc, stack_rpcs

    rpcs = stack_rpcs(ring_rpcs(8, curvature=2e-3), "cpu")
    ca, cb, pa, pb = rpc_duos(rpcs, 300, seed=5)
    monkeypatch.setenv("SATBA_TRIANG_CHUNK", "128")
    launches = ttri.rpc_triangulate.launches
    pts3d, err = ttri.rpc_triangulate(rpcs, ca, cb, pa, pb)
    want = ttri.rpc_triangulation(index_rpc(rpcs, ca), index_rpc(rpcs, cb), pa, pb)
    assert torch.equal(pts3d, want[0]) and torch.equal(err, want[1])
    assert ttri.rpc_triangulate.launches == launches
    empty = ttri.rpc_triangulate(rpcs, ca[:0], cb[:0], pa[:0], pb[:0])
    assert empty[0].shape == (0, 3) and empty[1].shape == (0,)
    with pytest.raises(ValueError, match="unsupported device"):
        ttri.rpc_triangulate(rpcs, *(t.to("meta") for t in (ca, cb, pa, pb)))


def test_table_pass_at_1000_cameras_holds_no_dense_array(monkeypatch):
    """At 1000 cameras the pass on a table-built problem allocates no
    cameras x tracks array (numpy's allocations traced; the duos' RPC
    triangulation, ~1 ms a duo on one CPU thread, replaced by zeros) and
    its answer holds no C."""
    scene = demo.make_scene_arrays(n_cam=1000, n_pts=20000, obs_per_pt=4, seed=2, device="cpu")
    p = demo.scene_to_baparams(scene)
    p.pairs_to_triangulate = ring(1000, [1, 2, 3])
    err = synthetic_errors(p.n_obs, 2, share=0.02)

    monkeypatch.setattr(ttri, "rpc_triangulation", lambda rpc_a, rpc_b, pts_a, pts_b, reads: (
        torch.zeros(pts_a.shape[:-1] + (3,), dtype=torch.float64),
        torch.zeros(pts_a.shape[:-1], dtype=torch.float64)))
    tracemalloc.start()
    try:
        p2 = tout.rm_outliers(err, p, device="cpu")
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert not hasattr(p2, "C") and 0 < p2.n_obs < p.n_obs
    assert peak < p.n_cam * p.n_pts // 2, peak  # a bool (M, N) array alone is M N bytes


def _spans_of(fn):
    from torch.profiler import ProfilerActivity, profile

    from sat_bundleadjust_tpu_torch.utils import profiling

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    spans = profiling.spans()
    profiling.reset()
    return out, spans


def test_a_table_problem_passes_through_the_robust_stage():
    """A from_obs_table problem with 2% of its observations moved 10-30 px
    through the pipeline's rounds: soft-L1, the table pass (its spans and
    counts), a new solver, L2, reconstruct_vars."""
    scene = demo.make_scene_arrays(n_cam=12, n_pts=1200, obs_per_pt=4, seed=4, device="cpu")
    rng = np.random.RandomState(5)
    moved = rng.choice(len(scene["pts2d"]), int(0.02 * len(scene["pts2d"])), replace=False)
    ang = rng.uniform(0, 2 * np.pi, len(moved))
    scene["pts2d"][moved] += (np.stack([np.cos(ang), np.sin(ang)], 1)
                              * rng.uniform(10, 30, len(moved))[:, None])
    p = demo.scene_to_baparams(scene)
    p = BAParams.from_obs_table(p.pts_ind, p.cam_ind, p.pts2d, p.pts3d, p.cameras, "rpc",
                                p.camera_centers, ring(12, [1, 2, 3]),
                                {"verbose": False, "n_pts_fix": 30})
    _, _, _, err, soft = BASolver(p, device=CPU).solve(SOFT_L1_ROUND)
    p2, spans = _spans_of(lambda: tout.rm_outliers(err, p, device="cpu"))
    (outer,) = [s for s in spans if s[2] == "ba.outliers"]
    children = {s[2] for s in spans if s[1] == outer[0]}
    assert children == {"ba.outliers.thresholds", "ba.outliers.remove", "ba.outliers.filter",
                        "ba.outliers.triangulate", "ba.outliers.rebuild"}
    a = outer[5]
    assert a["observations"] == p.n_obs and a["cameras"] == 12 and a["tracks_in"] == p.n_pts
    assert a["tracks_out"] == p2.n_pts and a["removed"] >= len(moved) and a["host_reads"] >= 5
    (tri,) = [s for s in spans if s[2] == "ba.outliers.triangulate"]
    assert tri[5]["duos"] > p2.n_pts and tri[5]["tracks"] == p2.n_pts

    kept = set(zip(p2.pts_prev_indices[p2.pts_ind].tolist(), p2.cam_ind.tolist()))
    assert not kept & set(zip(scene["pts_ind"][moved].tolist(), scene["cam_ind"][moved].tolist()))
    assert not hasattr(p2, "C") and 0 < p2.n_pts_fix <= 30
    assert np.all(np.diff(p2.pts_prev_indices) > 0)
    assert np.array_equal(p2.pts3d[: p2.n_pts_fix], p.pts3d[p2.pts_prev_indices[: p2.n_pts_fix]])
    _, (cam, pts), _, err2, l2 = BASolver(p2, device=CPU).solve(None)
    assert float(np.mean(err2)) < 0.15 and soft["iterations"] > 1 and l2["iterations"] > 1
    pts_c, cams_c = p2.reconstruct_vars(cam, pts, p.pts3d, p.cameras)
    assert pts_c.shape == p.pts3d.shape and len(cams_c) == 12
    np.testing.assert_array_equal(pts_c[p2.pts_prev_indices], pts.numpy())


def test_robust_stage_against_the_plain_reference():
    """The benchmark's robust stage at 16 cameras on the CPU, the port
    against portbench/reference/ba_clean.py: the reference's rule keeps the
    observations the port kept from the port's own soft-L1 errors, and the
    numbers of the cell's check lie within its limits."""
    from portbench.drivers import ba_clean as driver
    from portbench.reference import ba_clean as ref
    from portbench.spec import ROOT

    with open(os.path.join(ROOT, "portbench", "configs", "rpc_ba1000_clean.json")) as f:
        config = dict(json.load(f), n_cam=16, n_pts=1500)
    with open(os.path.join(ROOT, "portbench", "limits", "rpc_ba1000_clean.robust.json")) as f:
        limits = json.load(f)
    stages = driver.make(config, 2 ** 31 + 11, CPU)
    q = stages.problems["window"]
    p = stages.params(q)
    _, _, _, err, _ = BASolver(p, device=CPU).solve(stages.soft_l1)
    p2 = tout.rm_outliers(err, p, device="cpu")
    order = np.lexsort((q["cam_ind"], q["pts_ind"]))
    err_q = np.empty_like(err)
    err_q[order] = err
    kept = ref.kept_rows(torch.as_tensor(err_q), torch.as_tensor(q["cam_ind"]),
                         torch.as_tensor(q["pts_ind"]), 16, 1500, stages.pairs).numpy()
    port = np.asarray(p2.pts_prev_indices, np.int64)[p2.pts_ind] * 16 + p2.cam_ind
    np.testing.assert_array_equal(np.sort(port), np.sort(q["pts_ind"][kept] * 16
                                                         + q["cam_ind"][kept]))

    rec = stages(0)
    (numbers,) = driver.check(stages, [rec])
    assert numbers["removed_diff"] == 0 and numbers["moved_kept"] == 0
    for k, lim in limits.items():
        assert numbers[k] <= lim["max"], (k, numbers[k], lim)
