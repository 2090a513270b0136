"""Parity of the port's RPC refit (ba/rpcfit.py) with the JAX package's.

The scene: the demo RPCs of utils/demo.py (one of them with nonlinear
denominators), corrective rotations of ~2e-5 rad drawn from a seed, the
perspective camera centers, and a global transform of a few metres. Both
packages run fit_rpcs_batched (JAX on its CPU backend, the port with
device="cpu"). Tolerances:
- margins: equal (a discrete test on the hull of the fitted grid);
- fit error per camera, max and median: 1e-6 px (measured <= 1.6e-9 px;
  the 39x39 normal equations are solved in other summation orders);
- the refit RPCs on a ground grid: 1e-3 px of JAX's (measured <= 2.1e-9);
- the fit error itself: below 1e-3 px (measured 4.5e-5 px).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_bundleadjust_tpu.ba import rpcfit as jfit
from sat_bundleadjust_tpu.models.rpc import RPCModel as JRPC
from sat_bundleadjust_tpu.models.rpc import rpc_projection_np as jproj

from sat_bundleadjust_tpu_torch.ba import rpcfit as tfit
from sat_bundleadjust_tpu_torch.models.cameras import SatelliteImage
from sat_bundleadjust_tpu_torch.models.ellipsoid import latlon_to_ecef_np
from sat_bundleadjust_tpu_torch.models.rpc import RPCModel, rpc_projection_np
from sat_bundleadjust_tpu_torch.utils.demo import make_synthetic_rpc

M = 5
OFFSET = {"col0": 0.0, "row0": 0.0, "width": 3200, "height": 1350}
GT = np.array([1.5, -2.0, 0.7])


def refit_inputs(seed=0, n_cam=M):
    """RPCs (camera 0 with nonlinear denominators), Rt vectors, offsets and
    the points each camera sees."""
    rng = np.random.RandomState(seed)
    rpcs, rts = [], []
    for i in range(n_cam):
        r = make_synthetic_rpc(view_dx=300 * np.cos(2 * np.pi * i / n_cam),
                               view_dy=300 * np.sin(2 * np.pi * i / n_cam))
        if i == 0:
            den = r.line_den.copy()
            den[1], den[2] = 0.05, -0.03
            r = r._replace(line_den=den, samp_den=den.copy())
        im = SatelliteImage("x.tif", r, offset=dict(OFFSET))
        im.set_camera_center()
        rpcs.append(r)
        rts.append(np.concatenate([rng.normal(0, 2e-5, 3), np.zeros(3), im.center]))
    lat = 11.02 + rng.uniform(-0.01, 0.01, 40)
    lon = -72.71 + rng.uniform(-0.01, 0.01, 40)
    pts = np.stack(latlon_to_ecef_np(lat, lon, np.full(40, 50.0)), axis=1) + GT
    return rpcs, rts, [dict(OFFSET) for _ in range(n_cam)], [pts] * n_cam


def ground_grid():
    g = np.linspace(-1, 1, 7)
    LO, LA, AL = np.meshgrid(-72.71 + 0.03 * g, 11.02 + 0.02 * g, np.linspace(-500, 600, 5))
    return LO.ravel(), LA.ravel(), AL.ravel()


@pytest.fixture(scope="module")
def both_fits():
    rpcs, rts, offs, pts = refit_inputs()
    res_j = jfit.fit_rpcs_batched(rts, GT, [JRPC(*r) for r in rpcs], offs, pts)
    stats = {}
    res_t = tfit.fit_rpcs_batched(rts, GT, rpcs, offs, pts, device="cpu", stats=stats)
    return res_j, res_t, stats


def test_fit_rpcs_batched_matches_jax(both_fits):
    res_j, res_t, stats = both_fits
    assert len(res_j) == len(res_t) == M
    lon, lat, alt = ground_grid()
    for (rj, ej, mj), (rt, et, mt) in zip(res_j, res_t):
        assert mt == mj
        assert et.shape == ej.shape == (1000,)
        assert abs(et.max() - ej.max()) < 1e-6 and abs(np.median(et) - np.median(ej)) < 1e-6
        assert et.max() < 1e-3
        pj = np.stack(jproj(rj, lon, lat, alt), axis=1)
        pt = np.stack(rpc_projection_np(rt, lon, lat, alt), axis=1)
        assert np.abs(pt - pj).max() < 1e-3
        for f in RPCModel._fields:
            assert np.asarray(getattr(rt, f)).dtype == np.float64
    # at least one camera needed a wider margin: the doubling loop ran
    assert len({m for _, _, m in res_t}) > 1 and stats["rounds"] > 1
    # one sync per IRLS iteration at most, plus one per margin round
    assert stats["host_syncs"] <= stats["rounds"] * (tfit.MAX_IRLS_ITERS + 2)


def _irls_case():
    """Normalized correspondences whose IRLS needs 1, 3, 9 and 11
    iterations: a rational map plus quartic terms of growing amplitude."""
    rng = np.random.RandomState(0)
    n_cam, n = 4, 1000
    locs = rng.uniform(-1, 1, (n_cam, n, 3))
    target = np.empty((n_cam, n, 2))
    for m, amp in enumerate([0.0, 0.5, 1.0, 2.0]):
        x, y, z = locs[m, :, 0], locs[m, :, 1], locs[m, :, 2]
        target[m, :, 0] = (x + 0.1 * y + 0.05 * z) / (1 + 0.1 * x) + amp * x ** 4
        target[m, :, 1] = (y - 0.2 * x + 0.1 * z) / (1 + 0.05 * y) + amp * y ** 2 * z ** 2
    return target, locs


def _rational(coeffs, locs):
    from sat_bundleadjust_tpu_torch.models.rpc import _np_basis

    b = _np_basis(locs[..., 1], locs[..., 0], locs[..., 2])
    return np.stack([(b @ coeffs[40:60]) / (b @ coeffs[60:80]), (b @ coeffs[0:20]) / (b @ coeffs[20:40])],
                    axis=-1)


def test_irls_per_camera_convergence_mask(monkeypatch):
    """Cameras that stop at different IRLS iterations: the batched port
    keeps a stopped camera's state, as JAX's vmapped while_loop does. The
    fitted maps agree with JAX's within 1e-9 (normalized units; the
    coefficients of camera 0, an exact rational map, are ill-determined and
    differ by 2e-7), and with the camera's run alone within the same 1e-9
    (a batch of one takes other matmul kernels: 9.4e-10 measured)."""
    target, locs = _irls_case()
    stats = {}
    ct = tfit._irls_coeffs(torch.as_tensor(target), torch.as_tensor(locs), stats).numpy()
    cj = np.asarray(jax.vmap(jfit._irls_coeffs)(jnp.asarray(target), jnp.asarray(locs)))
    assert list(stats["irls_iters"]) == [1, 3, 9, 11]
    assert stats["host_syncs"] == 12
    for m in range(len(target)):
        np.testing.assert_allclose(_rational(ct[m], locs[m]), _rational(cj[m], locs[m]),
                                   rtol=0, atol=1e-9)
        alone = {}
        c1 = tfit._irls_coeffs(torch.as_tensor(target[m:m + 1]), torch.as_tensor(locs[m:m + 1]),
                               alone).numpy()[0]
        assert alone["irls_iters"][0] == stats["irls_iters"][m]
        np.testing.assert_allclose(_rational(c1, locs[m]), _rational(ct[m], locs[m]),
                                   rtol=0, atol=1e-9)
    # running camera 1 to the slowest camera's count (11) gives another map:
    # the mask is what keeps it at its own 3 iterations
    monkeypatch.setattr(tfit, "IRLS_TOL", 0.0)
    monkeypatch.setattr(tfit, "MAX_IRLS_ITERS", 11)
    c11 = tfit._irls_coeffs(torch.as_tensor(target[1:2]), torch.as_tensor(locs[1:2])).numpy()[0]
    assert np.abs(_rational(c11, locs[1]) - _rational(cj[1], locs[1])).max() > 1e-7


def test_irls_failed_factorization_gives_nan():
    """A camera whose column normal matrix cannot be factored (a NaN
    target) gets NaN column coefficients, as in JAX, without raising and
    without touching its row coefficients or the other cameras."""
    target, locs = _irls_case()
    target = target.copy()
    target[2, 5, 0] = np.nan
    ct = tfit._irls_coeffs(torch.as_tensor(target), torch.as_tensor(locs)).numpy()
    cj = np.asarray(jax.vmap(jfit._irls_coeffs)(jnp.asarray(target), jnp.asarray(locs)))
    assert np.all(np.isnan(ct[2, 40:60])) and np.all(np.isnan(ct[2, 61:80]))
    assert np.array_equal(np.isnan(ct), np.isnan(cj))
    for m in (0, 1, 3):
        np.testing.assert_allclose(_rational(ct[m], locs[m]), _rational(cj[m], locs[m]),
                                   rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_lsq_numpy_twin(seed):
    """The host twin (np.linalg.solve) on the same grid: the same numpy
    operations in the same order, so identical coefficients."""
    rng = np.random.RandomState(seed)
    rpcs, _, _, _ = refit_inputs(seed)
    r = rpcs[seed]
    cols, rows = rng.uniform(0, 3200, 300), rng.uniform(0, 1350, 300)
    alts = rng.uniform(-500, 600, 300)
    lons, lats = jfit.RPCModel(*r).localization(cols, rows, alts)
    locs = np.stack([lons, lats, alts], axis=1)
    target = np.stack([cols, rows], axis=1) + rng.normal(0, 1e-3, (300, 2))
    fj, ft = jfit.weighted_lsq(target, locs), tfit.weighted_lsq(target, locs)
    for f in RPCModel._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ft, f)), np.asarray(getattr(fj, f)))
    np.testing.assert_array_equal(tfit.check_errors(ft, locs, target),
                                  jfit.check_errors(fj, locs, target))


def test_fit_Rt_corrected_rpc_host_path():
    """The one-camera host path: the same margin and fit errors as JAX's,
    and within 1e-3 px of the batched port's fit."""
    rpcs, rts, offs, pts = refit_inputs(n_cam=2)
    lon, lat, alt = ground_grid()
    for k in range(2):
        rj, ej, mj = jfit.fit_Rt_corrected_rpc(rts[k], GT, JRPC(*rpcs[k]), offs[k], pts[k])
        rt, et, mt = tfit.fit_Rt_corrected_rpc(rts[k], GT, rpcs[k], offs[k], pts[k])
        assert mt == mj
        np.testing.assert_allclose(et, ej, rtol=0, atol=1e-6)
        pj = np.stack(jproj(rj, lon, lat, alt), axis=1)
        pt = np.stack(rpc_projection_np(rt, lon, lat, alt), axis=1)
        assert np.abs(pt - pj).max() < 1e-3
    rb, _, _ = tfit.fit_rpcs_batched(rts[1:], GT, rpcs[1:], offs[1:], pts[1:], device="cpu")[0]
    pb = np.stack(rpc_projection_np(rb, lon, lat, alt), axis=1)
    assert np.abs(pb - pt).max() < 1e-3


def test_refit_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    rpcs, rts, offs, pts = refit_inputs(n_cam=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfit.fit_rpcs_batched(rts, GT, rpcs, offs, pts)
    assert tfit.fit_rpcs_batched([], GT, [], [], [], device="cpu") == []
