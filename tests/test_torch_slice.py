"""The bundle-adjustment stage of the pipeline as a whole, port against the
JAX package on the CPU: define the problem through the C-matrix
constructor, solve with the soft-L1 loss, remove outlier observations
(with re-triangulation), solve with the L2 loss, reconstruct the cameras
and points. Also the re-triangulation (ops/triangulate.py) and the
outlier thresholds (ba/outliers.py) on their own."""

import numpy as np
import pytest

from test_torch_common import both_problems, jax_scene

from sat_bundleadjust_tpu.ba import outliers as jout
from sat_bundleadjust_tpu.ba import solver as jsolver
from sat_bundleadjust_tpu.ops import triangulate as jtri

from sat_bundleadjust_tpu_torch.ba import outliers as tout
from sat_bundleadjust_tpu_torch.ba import solver as tsolver
from sat_bundleadjust_tpu_torch.ops import triangulate as ttri

SOFT_L1 = {"loss": "soft_l1", "f_scale": 1.0, "max_iter": 300}


def _removed(p, C_new):
    """(camera, track) pairs of the observations C_new drops from p.C."""
    gone = ~np.isnan(p.C[::2]) & np.isnan(C_new[::2])
    return set(zip(*np.nonzero(gone)))


def test_triangulation_matches_jax():
    scene = jax_scene(n_cam=6, n_pts=400, seed=12)
    jp, tp = both_problems(scene, dense_c=True)
    jb = jtri.build_triangulation_batch(jp.C, jp.pairs_to_triangulate)
    tb = ttri.build_triangulation_batch(tp.C, tp.pairs_to_triangulate)
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    pj = jtri.init_pts3d(jp.C, jp.cameras, "rpc", jp.pairs_to_triangulate)
    pt = ttri.init_pts3d(tp.C, tp.cameras, "rpc", tp.pairs_to_triangulate, device="cpu")
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
        Ct, thr_t, nt = tout.compute_obs_to_remove(e, tp, **kw)
        np.testing.assert_array_equal(Ct, Cj)
        assert thr_t == thr_j and nt == nj > 0


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

    Cj, thr_j, _ = jout.compute_obs_to_remove(je_soft, jp)
    Ct, thr_t, _ = tout.compute_obs_to_remove(te_soft, tp)
    rm_j, rm_t = _removed(jp, Cj), _removed(tp, Ct)
    assert len(rm_j) >= 0.015 * jp.n_obs
    for cam, pt in rm_j ^ rm_t:
        k = np.nonzero((jp.cam_ind == cam) & (jp.pts_ind == pt))[0][0]
        assert abs(je_soft[k] - thr_j[cam]) <= 1e-6 and abs(te_soft[k] - thr_t[cam]) <= 1e-6

    jp2 = jout.rm_outliers(je_soft, jp)
    tp2 = tout.rm_outliers(te_soft, tp, device="cpu")
    if rm_j == rm_t:
        for name in ("pts_ind", "cam_ind", "pts2d", "pts_prev_indices", "C"):
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
