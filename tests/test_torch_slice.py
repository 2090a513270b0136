"""The bundle-adjustment stage of the pipeline as a whole, port against the
JAX package on the CPU: define the problem through the C-matrix
constructor, solve with the soft-L1 loss, remove outlier observations
(with re-triangulation), solve with the L2 loss, reconstruct the cameras
and points. Also the re-triangulation (ops/triangulate.py) and the
outlier thresholds (ba/outliers.py) on their own."""

import numpy as np
import pytest
import torch

from test_torch_common import both_problems, jax_scene

from sat_bundleadjust_tpu.ba import outliers as jout
from sat_bundleadjust_tpu.ba import solver as jsolver
from sat_bundleadjust_tpu.ops import triangulate as jtri

from sat_bundleadjust_tpu_torch.ba import outliers as tout
from sat_bundleadjust_tpu_torch.ba import solver as tsolver
from sat_bundleadjust_tpu_torch.ops import triangulate as ttri

SOFT_L1 = {"loss": "soft_l1", "f_scale": 1.0, "max_iter": 300}


def _removed(p, C_new):
    """(camera, track) pairs of the observations C_new drops from the JAX
    problem p's C."""
    gone = ~np.isnan(p.C[::2]) & np.isnan(C_new[::2])
    return set(zip(*np.nonzero(gone)))


def _dropped(p, p2):
    """(camera, track) pairs of the observations of p that the problem p2
    (rm_outliers' answer) no longer holds, tracks numbered as in p."""
    track = np.searchsorted(p.pts_prev_indices, p2.pts_prev_indices)[p2.pts_ind]
    kept = set(zip(p2.cam_ind.tolist(), track.tolist()))
    return set(zip(p.cam_ind.tolist(), p.pts_ind.tolist())) - kept


def _flagged(err, p, **kw):
    """The port's rm_outliers(err, p) and the count of the observations it
    flagged (those above their camera's threshold), as its `ba.outliers`
    span records it."""
    from torch.profiler import ProfilerActivity, profile

    from sat_bundleadjust_tpu_torch.utils import profiling

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        p2 = tout.rm_outliers(err, p, device="cpu", **kw)
    (outer,) = [s[5] for s in profiling.spans() if s[2] == "ba.outliers"]
    profiling.reset()
    return p2, outer["removed"]


def test_triangulation_matches_jax():
    scene = jax_scene(n_cam=6, n_pts=400, seed=12)
    jp, tp = both_problems(scene, dense_c=True)
    jb = jtri.build_triangulation_batch(jp.C, jp.pairs_to_triangulate)
    pts, cam = torch.as_tensor(tp.pts_ind).long(), torch.as_tensor(tp.cam_ind).long()
    a, b = ttri.observation_duos(pts, cam, tp.n_pts, tp.n_cam,
                                 ttri.pair_lookup(tp.pairs_to_triangulate, tp.n_cam, "cpu"))
    a, b = a.numpy(), b.numpy()
    got = sorted(zip(tp.cam_ind[a].tolist(), tp.cam_ind[b].tolist(), tp.pts_ind[a].tolist(),
                     map(tuple, tp.pts2d[a].tolist()), map(tuple, tp.pts2d[b].tolist())))
    want = sorted(zip(jb["cam_a"].tolist(), jb["cam_b"].tolist(), jb["track"].tolist(),
                      map(tuple, jb["pts_a"].tolist()), map(tuple, jb["pts_b"].tolist())))
    assert got == want and len(got) > 0
    pj = jtri.init_pts3d(jp.C, jp.cameras, "rpc", jp.pairs_to_triangulate)
    pt = ttri.init_pts3d(jp.C, tp.cameras, "rpc", tp.pairs_to_triangulate, device="cpu")
    # f64 on both sides; the secant search stops on |lambda| < 1e-5, and
    # last-bit differences of the transcendentals can move that stop by
    # one step on a few duos: 1e-4 m (the points lie ~6.4e6 m from the
    # origin, the scene's noise is 0.1 px ~ 0.2 m)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)


def test_outlier_thresholds_match_jax():
    rng = np.random.RandomState(0)
    err = np.concatenate([np.abs(rng.randn(500)) * 0.3, 10 + 5 * np.abs(rng.randn(25))])
    assert tout.get_elbow_value(err) == jout.get_elbow_value(err)
    assert tout.get_elbow_value(err[:2]) == jout.get_elbow_value(err[:2])
    scene = jax_scene(n_cam=6, n_pts=300, seed=3)
    jp, tp = both_problems(scene, dense_c=True)
    e = np.abs(rng.randn(jp.n_obs)) + (rng.rand(jp.n_obs) < 0.03) * 20.0
    for kw in ({}, {"predef_thr": 1.5}, {"reference_rounding": True}):
        Cj, thr_j, nj = jout.compute_obs_to_remove(e, jp, **kw)
        if not kw:
            thr_t = tout.camera_thresholds(torch.as_tensor(e), torch.as_tensor(tp.cam_ind).long(),
                                           tp.n_cam)
            assert thr_t.tolist() == thr_j
        # the port's pass drops the flagged observations and the tracks they
        # leave without 2 observations or a pair
        tp2, nt = _flagged(e, tp, **kw)
        flagged, dropped = _removed(jp, Cj), _dropped(tp, tp2)
        assert nt == nj > 0 and flagged <= dropped
        gone = set(range(tp.n_pts)) - set(np.searchsorted(tp.pts_prev_indices,
                                                          tp2.pts_prev_indices).tolist())
        assert all(track in gone for _, track in dropped - flagged)


@pytest.mark.parametrize("mode", [None, "cg"])
def test_ba_stage_matches_jax(mode):
    """Steps 7-10 of the pipeline with 2% of the observations moved by
    10-30 px. The removed observations are the same set (or differ only
    within 1e-6 px of a camera's threshold), and the final mean
    reprojection error agrees within 1e-3 px. mode None is each package's
    CPU default (dense); "cg" is the mode the card runs."""
    scene = jax_scene(n_cam=10, n_pts=1000, seed=11)
    jp, tp = both_problems(scene, dense_c=True, outliers=(0.02, 5))

    _, _, je0, je_soft, jit1 = jsolver.run_ba_optimization(jp, SOFT_L1, schur_mode=mode)
    _, _, te0, te_soft, tit1 = tsolver.run_ba_optimization(tp, SOFT_L1, schur_mode=mode,
                                                           device="cpu")
    np.testing.assert_allclose(te0, je0, rtol=1e-5, atol=1e-6)
    assert abs(tit1 - jit1) <= 2

    # the observations each package's pass drops (the flagged ones, and the
    # tracks they leave without 2 observations or a pair): the same, or
    # apart only on tracks with an error within 1e-6 px of its camera's
    # threshold on both sides
    thr_j = np.asarray(jout.compute_obs_to_remove(je_soft, jp)[1])
    thr_t = tout.camera_thresholds(torch.as_tensor(te_soft), torch.as_tensor(tp.cam_ind).long(),
                                   tp.n_cam).numpy()
    jp2 = jout.rm_outliers(je_soft, jp)
    tp2 = tout.rm_outliers(te_soft, tp, device="cpu")
    rm_j, rm_t = _dropped(jp, jp2), _dropped(tp, tp2)
    assert len(rm_j) >= 0.015 * jp.n_obs
    for _, pt in rm_j ^ rm_t:
        k = np.nonzero(jp.pts_ind == pt)[0]
        cams = jp.cam_ind[k]
        assert np.any((np.abs(je_soft[k] - thr_j[cams]) <= 1e-6)
                      & (np.abs(te_soft[k] - thr_t[cams]) <= 1e-6))
    if rm_j == rm_t:
        for name in ("pts_ind", "cam_ind", "pts2d", "pts_prev_indices"):
            np.testing.assert_array_equal(getattr(tp2, name), getattr(jp2, name), err_msg=name)
        np.testing.assert_allclose(tp2.pts3d, jp2.pts3d, rtol=0, atol=1e-4)

    _, (jcam, jpts), _, je_l2, jit2 = jsolver.run_ba_optimization(jp2, None, schur_mode=mode)
    _, (tcam, tpts), _, te_l2, tit2 = tsolver.run_ba_optimization(tp2, None, schur_mode=mode,
                                                                  device="cpu")
    assert float(te_l2.mean()) < 0.15
    assert abs(float(te_l2.mean()) - float(je_l2.mean())) <= 1e-3
    assert abs(tit2 - jit2) <= 2

    pj, cj = jp2.reconstruct_vars(np.asarray(jcam), np.asarray(jpts), jp.pts3d, jp.cameras)
    pt, ct = tp2.reconstruct_vars(tcam, tpts, tp.pts3d, tp.cameras)
    assert len(ct) == len(cj) and pt.shape == pj.shape
    # the solved corrections are rotations of ~2e-5 rad. LM stops at
    # ftol = 1e-4 on both sides, at points of the flat valley of a common
    # rotation compensated by the points: 5e-8 rad apart with torch on 8
    # threads, 1.6e-7 rad on 1 (sums in another order); 1e-6 rad
    np.testing.assert_allclose(np.stack([c.reshape(9) for c in ct]),
                               np.stack([np.asarray(c).reshape(9) for c in cj]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=0.05)
