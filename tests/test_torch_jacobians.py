"""Parity of the port's residuals and analytic Jacobians (ops/jacobians.py)
with the JAX package, and of the analytic Jacobians with forward-mode AD
(torch.func.jacfwd) through the trig-based projection chain."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_common import both_problems, jax_scene, t

from sat_bundleadjust_tpu.ops.fastgeo import anchors_from_rpcs as j_anchors
from sat_bundleadjust_tpu.ops.jacobians import residuals_and_jacobians_rpc as j_rj
from sat_bundleadjust_tpu.ops.jacobians import residuals_rpc as j_res

from sat_bundleadjust_tpu_torch.models import ellipsoid as tell
from sat_bundleadjust_tpu_torch.models.rpc import index_rpc, rpc_projection
from sat_bundleadjust_tpu_torch.ops import project as tproj
from sat_bundleadjust_tpu_torch.ops.fastgeo import anchors_from_rpcs as t_anchors
from sat_bundleadjust_tpu_torch.ops.jacobians import residuals_and_jacobians_rpc as t_rj
from sat_bundleadjust_tpu_torch.ops.jacobians import residuals_rpc as t_res


def _inputs(correction_params):
    scene = jax_scene(n_cam=6, n_pts=300, seed=2)
    jp, tp = both_problems(scene, d={"correction_params": correction_params})
    rng = np.random.RandomState(9)
    cam = np.array(jp.cam_params)
    cam[:, :3] += 3e-5 * rng.uniform(-1, 1, (jp.n_cam, 3))
    cam[:, 3:6] += 0.3 * rng.uniform(-1, 1, (jp.n_cam, 3))
    pts = jp.pts3d + 0.5
    return jp, tp, cam, pts


@pytest.mark.parametrize("correction_params", [["R"], ["R", "T"]])
def test_residuals_and_jacobians_match_jax(correction_params):
    jp, tp, cam, pts = _inputs(correction_params)
    n_params = jp.n_params
    ja = {k: jnp.asarray(v) for k, v in j_anchors(jp.rpcs).items()}
    jargs = (jnp.asarray(pts), jp.rpcs, jnp.asarray(cam), jnp.asarray(jp.pts_ind),
             jnp.asarray(jp.cam_ind), jnp.asarray(jp.pts2d), jnp.asarray(jp.pts2d_w))
    targs = (t(pts), tp.rpcs, t(cam), t(tp.pts_ind).long(), t(tp.cam_ind).long(),
             t(tp.pts2d), t(tp.pts2d_w))
    ta = t_anchors(tp.rpcs)

    r_j = np.asarray(j_res(*jargs, ja))
    r_t = t_res(*targs, ta).numpy()
    # the residual cancels proj - obs (~3e3 px each): besides rtol 1e-9 of
    # the residual, allow 1e-12 of the coordinates, the rounding of the
    # projection's f64 sums, which torch and XLA take in other orders
    # (1.2e-9 px measured)
    atol = 1e-12 * np.abs(tp.pts2d).max()
    np.testing.assert_allclose(r_t, r_j, rtol=1e-9, atol=atol)

    # f64 Jacobians on both sides: the same closed-form chain
    rj, Jcj, Jpj = j_rj(*jargs, n_params, ja, jac_dtype=jnp.float64)
    rt, Jct, Jpt = t_rj(*targs, n_params, ta, jac_dtype=torch.float64)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-9, atol=atol)
    np.testing.assert_allclose(Jct.numpy(), np.asarray(Jcj), rtol=1e-8,
                               atol=1e-12 * np.abs(np.asarray(Jcj)).max())
    np.testing.assert_allclose(Jpt.numpy(), np.asarray(Jpj), rtol=1e-8,
                               atol=1e-12 * np.abs(np.asarray(Jpj)).max())
    # the residual of the Jacobian path is the residual path's, bit for bit
    np.testing.assert_array_equal(rt.numpy(), r_t)

    # the default f32 Jacobians sit at f32 rounding of the f64 ones
    _, Jc32, Jp32 = t_rj(*targs, n_params, ta)
    assert Jc32.dtype == torch.float32 and Jp32.dtype == torch.float32
    np.testing.assert_allclose(Jc32.double().numpy(), Jct.numpy(), rtol=1e-4,
                               atol=1e-5 * np.abs(Jct.numpy()).max())


def test_analytic_jacobian_matches_torch_jacfwd():
    """Tolerances of tests/test_jacobians.py: the analytic geodetic
    derivative uses the exact inverse function theorem while AD
    differentiates the approximate (one-pass Bowring) inverse formula."""
    jp, tp, cam, pts = _inputs(["R", "T"])
    n_params = tp.n_params
    pts_ind = t(tp.pts_ind).long()
    cam_ind = t(tp.cam_ind).long()
    cam_t, pts_t = t(cam), t(pts)
    pts2d, w = t(tp.pts2d), t(tp.pts2d_w)
    r_a, J_cam_a, J_pt_a = t_rj(pts_t, tp.rpcs, cam_t, pts_ind, cam_ind, pts2d, w,
                                n_params, t_anchors(tp.rpcs))

    rpc_k = index_rpc(tp.rpcs, cam_ind)

    def obs_fn(cam_opt, pt, cam_tail, rpc_leaf, obs2d, wk):
        xadj = tproj.adjust_pts3d(pt, torch.cat([cam_opt, cam_tail]))
        lat, lon, alt = tell.ecef_to_latlon(xadj[0], xadj[1], xadj[2])
        col, row = rpc_projection(rpc_leaf, lon, lat, alt)
        return wk * (torch.stack([col, row]) - obs2d)

    args = (cam_t[:, :n_params][cam_ind], pts_t[pts_ind], cam_t[:, n_params:][cam_ind],
            rpc_k, pts2d, w)
    r_b = torch.func.vmap(obs_fn)(*args)
    J_cam_b, J_pt_b = torch.func.vmap(torch.func.jacfwd(obs_fn, argnums=(0, 1)))(*args)

    np.testing.assert_allclose(r_a.numpy(), r_b.numpy(), rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(J_pt_a.double().numpy(), J_pt_b.numpy(), rtol=2e-5, atol=1e-10)
    np.testing.assert_allclose(J_cam_a.double().numpy(), J_cam_b.numpy(), rtol=2e-5,
                               atol=1e-6 * float(J_cam_b.abs().max()))
