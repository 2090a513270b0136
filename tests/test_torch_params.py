"""Parity of the port's problem set-up with the JAX package: the BAParams
tables of both constructors, the host-side index tables of ops/lm.py and
the LMProblem that ba/solver.build_problem assembles. All of these are
integer or copied float64 tables, so they must be identical."""

import numpy as np
import pytest
import torch

from test_torch_common import both_problems, jax_scene, rpc_arrays
from test_torch_cuda import assert_same_problem, numpy_problem

from sat_bundleadjust_tpu.ba import solver as jsolver
from sat_bundleadjust_tpu.ops import lm as jlm

from sat_bundleadjust_tpu_torch.ba import params as tparams
from sat_bundleadjust_tpu_torch.ba import solver as tsolver
from sat_bundleadjust_tpu_torch.ops import lm as tlm

TABLES = ("pts_ind", "cam_ind", "pts2d", "pts2d_w", "pts3d", "cam_params", "cam_opt_mask",
          "pts_opt_mask", "pts_prev_indices", "cam_prev_indices")
SCALARS = ("n_cam", "n_pts", "n_obs", "n_params", "n_cam_fix", "n_pts_fix", "n_cam_opt",
           "n_pts_opt", "pairs_to_triangulate", "cam_params_to_optimize")


def _assert_same_problem(jp, tp):
    for name in TABLES:
        a, b = getattr(tp, name), getattr(jp, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in SCALARS:
        assert getattr(tp, name) == getattr(jp, name), name
    assert not hasattr(tp, "C")  # the table is the port's only copy of the observations
    for a, b in zip(tp.rpcs, rpc_arrays(jp.rpcs)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(tp.opt_block(), jp.opt_block())


def _with_repeats(scene, seed=0):
    """The scene's table with 40 of its observations given again at other
    image points, in an order drawn from seed: (point, camera) keys that
    repeat, whose relative order only a stable sort keeps."""
    rng = np.random.RandomState(seed)
    k = rng.choice(len(scene["pts_ind"]), 40, replace=False)
    pts_ind = np.concatenate([scene["pts_ind"], scene["pts_ind"][k]])
    cam_ind = np.concatenate([scene["cam_ind"], scene["cam_ind"][k]])
    pts2d = np.concatenate([scene["pts2d"], scene["pts2d"][k] + rng.uniform(1, 2, (40, 2))])
    order = rng.permutation(len(pts_ind))
    return dict(scene, pts_ind=pts_ind[order], cam_ind=cam_ind[order], pts2d=pts2d[order])


@pytest.mark.parametrize("dense_c,table", [pytest.param(False, "demo", id="False"),
                                           pytest.param(True, "demo", id="True"),
                                           pytest.param(False, "repeats", id="repeats")])
@pytest.mark.parametrize("d", [{}, {"n_cam_fix": 2, "n_pts_fix": 7, "ref_cam_weight": 3.0,
                                   "correction_params": ["R", "T"]}])
def test_baparams_match_jax(dense_c, table, d):
    """Both constructors as in JAX; from_obs_table on a table whose keys
    repeat keeps np.lexsort's order."""
    scene = jax_scene(n_cam=8, n_pts=400, seed=1)
    if table == "repeats":
        scene = _with_repeats(scene)
        order = np.lexsort((scene["cam_ind"], scene["pts_ind"]))
    jp, tp = both_problems(scene, dense_c=dense_c, d=d)
    _assert_same_problem(jp, tp)
    if table == "repeats":
        np.testing.assert_array_equal(tparams.point_major_order(scene["pts_ind"],
                                                                scene["cam_ind"]), order)
        np.testing.assert_array_equal(tp.pts2d, scene["pts2d"][order])


def _reduced_problems():
    """The C-matrix constructor on a scene with a camera that observes
    nothing and 20 tracks seen by the frozen camera only: (JAX, port)."""
    from sat_bundleadjust_tpu.ba.params import BAParams as JBAParams

    from sat_bundleadjust_tpu_torch import convert

    scene = jax_scene(n_cam=6, n_pts=300, seed=4)
    n_cam, n_pts = 7, 300
    C = np.full((2 * n_cam, n_pts), np.nan)
    C[2 * scene["cam_ind"], scene["pts_ind"]] = scene["pts2d"][:, 0]
    C[2 * scene["cam_ind"] + 1, scene["pts_ind"]] = scene["pts2d"][:, 1]
    C[:, :20] = np.nan
    C[0:2, :20] = 100.0  # tracks 0..19 seen by camera 0 only, which is frozen
    # camera 6 observes nothing
    cams = list(scene["rpc_list"]) + [scene["rpc_list"][0]]
    centers = [c for c in scene["camera_centers"]] + [scene["camera_centers"][0]]
    pairs = [(i, j) for i in range(n_cam) for j in range(i + 1, n_cam)]
    d = {"n_cam_fix": 1, "n_pts_fix": 30, "verbose": False}
    jp = JBAParams(C, scene["pts3d"], cams, "rpc", pairs, centers, d)
    tp = tparams.BAParams(C, scene["pts3d"], convert.rpc_list_from_arrays(rpc_arrays(cams)),
                          "rpc", pairs, centers, d)
    return jp, tp


def test_baparams_reduce_matches_jax():
    """The C-matrix constructor's reduce pass: a camera with no observation
    and tracks seen only by frozen cameras are dropped, as in JAX."""
    jp, tp = _reduced_problems()
    assert tp.n_cam == 6 and tp.n_pts == 280
    _assert_same_problem(jp, tp)


@pytest.mark.parametrize("problem", ["demo", "reduced"])
def test_reconstruct_vars_matches_jax(problem):
    """The answer in the original indexing, as in JAX; on the reduced
    problem the points and cameras go back to positions that are not their
    own (pts_prev_indices and cam_prev_indices are not the identity)."""
    if problem == "demo":
        scene = jax_scene(n_cam=6, n_pts=200, seed=5)
        jp, tp = both_problems(scene, dense_c=True, d={"correction_params": ["R", "T"]})
        n_pts, n_cam = jp.n_pts + 3, jp.n_cam
    else:
        jp, tp = _reduced_problems()
        n_pts, n_cam = 300, 7
        assert not np.array_equal(tp.pts_prev_indices, np.arange(tp.n_pts))
    rng = np.random.RandomState(0)
    cam = jp.opt_block() + 1e-5 * rng.randn(*jp.opt_block().shape)
    pts = jp.pts3d + rng.randn(*jp.pts3d.shape)
    init = rng.randn(n_pts, 3)
    pj, cj = jp.reconstruct_vars(cam, pts, init, list(range(n_cam)))
    pt, ct = tp.reconstruct_vars(torch.as_tensor(cam), torch.as_tensor(pts), init,
                                 list(range(n_cam)))
    assert len(ct) == len(cj) == n_cam
    np.testing.assert_array_equal(pt, pj)
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tp.estimated_params, jp.estimated_params):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_matrix_models_raise_not_implemented():
    """The matrix camera models, which raised NotImplementedError until they
    were ported, now build through both constructors the JAX package's
    problem: the same parameter rows (1e-12 relative), layout and tables,
    with no stacked RPCs."""
    from sat_bundleadjust_tpu.ba.params import BAParams as JBAParams
    from sat_bundleadjust_tpu_torch.utils import demo

    for cam_model, params in (("affine", ["R", "T"]), ("perspective", ["R", "T", "K"])):
        s = demo.make_matrix_scene(cam_model, n_cam=4, n_pts=20)
        d = {"verbose": False, "correction_params": params}
        C = np.full((8, 20), np.nan)
        C[2 * s["cam_ind"], s["pts_ind"]] = s["pts2d"][:, 0]
        C[2 * s["cam_ind"] + 1, s["pts_ind"]] = s["pts2d"][:, 1]
        built = [
            (cls(C, s["pts0"], s["cameras_init"], cam_model, s["pairs"], s["camera_centers"], d),
             cls.from_obs_table(s["pts_ind"], s["cam_ind"], s["pts2d"], s["pts0"],
                                s["cameras_init"], cam_model, s["camera_centers"], s["pairs"], d))
            for cls in (JBAParams, tparams.BAParams)]
        for jp, tp in zip(*built):
            assert tp.rpcs is None and tp.n_params == jp.n_params
            np.testing.assert_allclose(tp.cam_params, jp.cam_params, rtol=1e-12, atol=1e-15)
            for name in ("pts_ind", "cam_ind", "pts2d", "pts3d", "cam_opt_mask"):
                np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name), err_msg=name)


@pytest.mark.parametrize("seed,obs_per_pt", [(0, 4), (2, 3)])
def test_index_tables_match_jax(seed, obs_per_pt):
    scene = jax_scene(n_cam=9, n_pts=500, seed=seed, obs_per_pt=obs_per_pt)
    jp, tp = both_problems(scene)
    # drop a few observations so that tracks and cameras have ragged lengths
    keep = np.ones(tp.n_obs, bool)
    keep[np.random.RandomState(seed).choice(tp.n_obs, 150, replace=False)] = False
    pts_ind, cam_ind = tp.pts_ind[keep], tp.cam_ind[keep]
    N, M, K = tp.n_pts, tp.n_cam, int(keep.sum())
    for a, b in zip(tlm.build_intra_track_pairs(pts_ind, N),
                    jlm.build_intra_track_pairs(pts_ind, N)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for ind, n in ((pts_ind, N), (cam_ind, M)):
        ta = tlm.build_gather_segments(ind, n)
        ja = jlm.build_gather_segments(ind, n)
        np.testing.assert_array_equal(ta, ja)
    pt_table = jlm.build_gather_segments(pts_ind, N)
    cam_table = jlm.build_gather_segments(cam_ind, M)
    np.testing.assert_array_equal(tlm.gather_table_values(pt_table, cam_ind, K, M),
                                  jlm.gather_table_values(pt_table, cam_ind, K, M))
    np.testing.assert_array_equal(tlm.gather_table_values(cam_table, pts_ind, K, N),
                                  jlm.gather_table_values(cam_table, pts_ind, K, N))
    np.testing.assert_array_equal(tlm.gather_table_values(cam_table, [], 0, N),
                                  jlm.gather_table_values(cam_table, [], 0, N))
    np.testing.assert_array_equal(tlm.build_obs_at(pts_ind, cam_ind, N, M),
                                  jlm.build_obs_at(pts_ind, cam_ind, N, M))
    dup = np.concatenate([pts_ind, pts_ind[:1]]), np.concatenate([cam_ind, cam_ind[:1]])
    assert tlm.build_obs_at(*dup, N, M) is None and jlm.build_obs_at(*dup, N, M) is None


def _case_problems(case):
    """The problems (JAX, port) of a test_build_problem_matches_jax case:
    the demo's table with ragged tracks and cameras (150 observations
    dropped), a camera with no observation, repeated (point, camera) keys,
    no observation at all, frozen cameras and points, 200 cameras, or
    perspective cameras with COMMON_K."""
    if case == "common_k":
        from sat_bundleadjust_tpu.ba.params import BAParams as JBAParams
        from sat_bundleadjust_tpu_torch.utils import demo

        s = demo.make_matrix_scene("perspective", n_cam=8, n_pts=300)
        args = (s["pts_ind"], s["cam_ind"], s["pts2d"], s["pts0"], s["cameras_init"],
                "perspective", s["camera_centers"], s["pairs"],
                {"verbose": False, "correction_params": ["R", "T", "K", "COMMON_K"]})
        return JBAParams.from_obs_table(*args), tparams.BAParams.from_obs_table(*args)
    d = {"n_cam_fix": 2, "n_pts_fix": 7} if case == "frozen" else None
    if case == "over_192_cameras":
        return both_problems(jax_scene(n_cam=200, n_pts=1500, seed=6), d=d)
    scene = jax_scene(n_cam=8, n_pts=400, seed=6)
    rng = np.random.RandomState(6)
    keep = np.ones(len(scene["pts_ind"]), bool)
    if case == "ragged":
        keep[rng.choice(len(keep), 150, replace=False)] = False
    elif case == "unobserved_camera":
        keep = scene["cam_ind"] != 3
    elif case == "empty":
        keep[:] = False
    elif case == "repeats":
        return both_problems(_with_repeats(scene), d=d)
    return both_problems(dict(scene, **{k: scene[k][keep] for k in ("pts_ind", "cam_ind",
                                                                    "pts2d")}), d=d)


# the tables that only a dense solve reads, by the solve that reads them
DENSE_TABLES = {tlm.DENSE_OBS_AT: ("obs_at",), tlm.DENSE_PAIRS: ("pair_k1", "pair_k2"),
                tlm.CG: ()}


@pytest.mark.parametrize("case,schur_mode,solve", [
    pytest.param("demo", None, tlm.DENSE_OBS_AT, id="demo"),
    pytest.param("ragged", None, tlm.DENSE_OBS_AT, id="ragged"),
    pytest.param("unobserved_camera", None, tlm.DENSE_OBS_AT, id="unobserved_camera"),
    pytest.param("repeats", None, tlm.DENSE_PAIRS, id="repeats"),
    pytest.param("empty", None, tlm.DENSE_OBS_AT, id="empty"),
    pytest.param("frozen", None, tlm.DENSE_OBS_AT, id="frozen"),
    pytest.param("over_192_cameras", None, tlm.CG, id="over_192_cameras"),
    pytest.param("common_k", None, tlm.CG, id="common_k"),
    pytest.param("demo", "cg", tlm.CG, id="explicit_cg"),
])
def test_build_problem_matches_jax(case, schur_mode, solve):
    """The port's LMProblem on the CPU, its index tables built by torch
    operations (ops/lm.problem_tables) for the Schur solve ops/lm.schur_solve
    chooses: dense up to 192 cameras (over obs_at; over the intra-track
    pairs where a (track, camera) pair repeats), the CG above 192 cameras,
    for COMMON_K and where it is asked for. The tables that only another
    solve reads are None; every table built holds JAX's tables and those of
    the numpy functions of ops/lm.py; the kernel's two layouts are int32 and every other index
    table int64."""
    jp, tp = _case_problems(case)
    jprob, _ = jsolver.build_problem(jp, schur_mode)
    tprob, tmode = tsolver.build_problem(tp, "cpu", schur_mode)
    assert tmode == ("cg" if solve == tlm.CG else "dense")
    cfg = tlm.LMConfig(schur_mode=tmode, tie_tail=tsolver.tie_tail(tp))
    assert tlm._solve_of(tprob, tp.n_cam, cfg) == solve
    for name in ("pair_k1", "pair_k2", "obs_at"):
        assert (getattr(tprob, name) is None) == (name not in DENSE_TABLES[solve]), name
    assert_same_problem(tprob, numpy_problem(tp, "cpu", solve))
    assert (tprob.cam_ind_pt is None) == (case == "empty")
    for name in tlm.LMProblem._fields:
        a, b = getattr(tprob, name), getattr(jprob, name)
        if a is None and name in ("pair_k1", "pair_k2", "obs_at"):
            continue
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert a.device.type == "cpu"
        if name in ("cam_ind_pt", "pts_ind_cam"):
            assert a.dtype == torch.int32
        elif a.dtype.is_floating_point:
            assert a.dtype == torch.float64
        else:
            assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
