"""Parity of the port's stereo helpers (models/stereo.py) with the JAX
package's, on the CPU.

Two views per scene: the synthetic RPCs of utils/demo.make_synthetic_rpc
(two view directions) and RPCs fitted to satellite pinholes 100 km off
nadir (utils/demo.pinhole_rpc). The same numpy models go to both packages.
Tolerance rtol 1e-9 (plus 1e-9 of the values' scale where they cross
zero): torch's and XLA's CPU libm differ in the last bits of sin, cos,
atan2 and sqrt (ROADMAP Queue 3, "libm last bits"); the estimation helpers
are the same numpy code and must agree exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sat_bundleadjust_tpu  # noqa: F401  (enables float64 in JAX)
from sat_bundleadjust_tpu.models import stereo as jstereo
from sat_bundleadjust_tpu.models.rpc import RPCModel as JRPCModel

from sat_bundleadjust_tpu_torch.models import stereo as tstereo
from sat_bundleadjust_tpu_torch.utils import demo as tdemo

torch.set_num_threads(1)
RTOL = 1e-9
H, W = 300, 400


def _jax_rpc(rpc):
    return JRPCModel(*[jnp.asarray(np.asarray(f, np.float64)) for f in rpc])


def _views(kind):
    if kind == "synthetic":
        rpcs = [tdemo.make_synthetic_rpc(view_dx=dx, view_dy=dy, img_halfsize=(W / 2, H / 2))
                for dx, dy in ((250.0, 0.0), (-180.0, 120.0))]
        Ps = None
    else:
        Ps = [tdemo.satellite_pinhole(view=(1e5 * np.cos(a), 1e5 * np.sin(a)), gsd=3.0,
                                      img_halfsize=(W / 2, H / 2)) for a in (0.3, 2.2)]
        rpcs = [tdemo.pinhole_rpc(P) for P in Ps]
    return rpcs, [_jax_rpc(r) for r in rpcs], Ps


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max(initial=0.0)), 1e-300)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def _pixels(n=12, seed=0):
    rng = np.random.RandomState(seed)
    return rng.uniform(0, W, n), rng.uniform(0, H, n)


def check_altitude_range_coarse(t, j, Ps):
    for sf in (1.0, 0.5):
        assert tstereo.altitude_range_coarse(t[0], sf) == jstereo.altitude_range_coarse(j[0], sf)


def check_geodesic_bounding_box(t, j, Ps):
    _close(tstereo.geodesic_bounding_box(t[0], 10, 20, W - 30, H - 40, device="cpu"),
           jstereo.geodesic_bounding_box(j[0], 10, 20, W - 30, H - 40))


def check_find_corresponding_point(t, j, Ps):
    x, y = _pixels()
    z = np.linspace(-100.0, 300.0, x.size)
    xt, yt, zt = tstereo.find_corresponding_point(t[0], t[1], x, y, z, device="cpu")
    xj, yj, zj = jstereo.find_corresponding_point(j[0], j[1], x, y, z)
    assert isinstance(xt, torch.Tensor) and xt.dtype == torch.float64
    _close(xt.numpy(), np.asarray(xj))
    _close(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(np.asarray(zt), np.asarray(zj))


def check_compute_height(t, j, Ps):
    m = jstereo.matches_from_rpc(j[0], j[1], 0, 0, W, H, 4)
    ht, et = tstereo.compute_height(t[0], t[1], *m.T, device="cpu")
    hj, ej = jstereo.compute_height(j[0], j[1], *m.T)
    _close(ht, hj)
    # the residuals are ~1e-9 px: compare them on the pixel scale
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-9 * W)
    # one scalar duo
    h1t, _ = tstereo.compute_height(t[0], t[1], *m[5], device="cpu")
    h1j, _ = jstereo.compute_height(j[0], j[1], *m[5])
    assert h1t.shape == (1,)
    _close(h1t, h1j)


def check_ground_control_points(t, j, Ps):
    out_t = tstereo.ground_control_points(t[0], 5, 7, W - 10, H - 20, -50.0, 250.0, 3, device="cpu")
    out_j = jstereo.ground_control_points(j[0], 5, 7, W - 10, H - 20, -50.0, 250.0, 3)
    for a, b in zip(out_t, out_j):
        _close(a, b)


def check_matches_from_rpc(t, j, Ps):
    mt = tstereo.matches_from_rpc(t[0], t[1], 0, 0, W, H, 5, device="cpu")
    mj = jstereo.matches_from_rpc(j[0], j[1], 0, 0, W, H, 5)
    assert mt.shape == (125, 4)
    _close(mt, mj)


def check_gsd_from_rpc(t, j, Ps):
    for z in (0.0, 120.0):
        _close(tstereo.gsd_from_rpc(t[0], z=z, device="cpu"), jstereo.gsd_from_rpc(j[0], z=z))


def check_fundamental_matrix_cameras(t, j, Ps):
    if Ps is None:  # affine views: the cameras of their matrix fit
        from sat_bundleadjust_tpu_torch.models.cameras import perspective_rpc_approx

        off = {"col0": 0, "row0": 0, "width": W, "height": H}
        Ps = [perspective_rpc_approx(r, off)[0] for r in t]
    np.testing.assert_array_equal(tstereo.fundamental_matrix_cameras(*Ps),
                                  jstereo.fundamental_matrix_cameras(*Ps))


def check_rectifying_similarities_from_affine_fundamental_matrix(t, j, Ps):
    from sat_bundleadjust_tpu.tracks.matching import affine_fundamental_matrix

    F = affine_fundamental_matrix(jstereo.matches_from_rpc(j[0], j[1], 0, 0, W, H, 5))
    for a, b in zip(tstereo.rectifying_similarities_from_affine_fundamental_matrix(F),
                    jstereo.rectifying_similarities_from_affine_fundamental_matrix(F)):
        np.testing.assert_array_equal(a, b)


def check_affine_transformation(t, j, Ps):
    m = jstereo.matches_from_rpc(j[0], j[1], 0, 0, W, H, 4)
    np.testing.assert_array_equal(tstereo.affine_transformation(m[:, :2], m[:, 2:]),
                                  jstereo.affine_transformation(m[:, :2], m[:, 2:]))


def check_translation(t, j, Ps):
    m = jstereo.matches_from_rpc(j[0], j[1], 0, 0, W, H, 4)
    np.testing.assert_array_equal(tstereo.translation(m[:, :2], m[:, 2:]),
                                  jstereo.translation(m[:, :2], m[:, 2:]))


CHECKS = [check_altitude_range_coarse, check_geodesic_bounding_box, check_find_corresponding_point,
          check_compute_height, check_ground_control_points, check_matches_from_rpc,
          check_gsd_from_rpc, check_fundamental_matrix_cameras,
          check_rectifying_similarities_from_affine_fundamental_matrix,
          check_affine_transformation, check_translation]


@pytest.mark.parametrize("kind", ["synthetic", "pinhole"])
@pytest.mark.parametrize("check", CHECKS, ids=lambda c: c.__name__[len("check_"):])
def test_stereo_matches_jax(kind, check):
    """Each function of models/stereo.py against the JAX package's on the
    same views."""
    t, j, Ps = _views(kind)
    check(t, j, Ps)


def test_stereo_entry_points_default_to_the_card():
    """Without device=, the RPC helpers ask for the card (and raise here,
    where there is none)."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    t, _, _ = _views("synthetic")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstereo.gsd_from_rpc(t[0])
