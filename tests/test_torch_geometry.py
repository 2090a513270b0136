"""Parity of the port's geometry with the JAX package on the CPU:
ellipsoid, rotations, RPC projection/localization on make_synthetic_rpc
models, and the demo scene.

Tolerance: 1e-9 px (or m / deg) absolute plus 1e-12 relative. Both sides
are float64; they differ only by the last bits of libm transcendentals
(atan2, sin, cos), which the ~6.4e6 m ECEF magnitudes turn into ~1e-9 m.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_common import jax_scene, rpc_arrays, t

from sat_bundleadjust_tpu.models import ellipsoid as jell
from sat_bundleadjust_tpu.models import rotations as jrot
from sat_bundleadjust_tpu.models import rpc as jrpc
from sat_bundleadjust_tpu.utils import demo as jdemo

from sat_bundleadjust_tpu_torch import convert
from sat_bundleadjust_tpu_torch.models import ellipsoid as tell
from sat_bundleadjust_tpu_torch.models import rotations as trot
from sat_bundleadjust_tpu_torch.models import rpc as trpc
from sat_bundleadjust_tpu_torch.utils import demo as tdemo

RTOL, ATOL = 1e-12, 1e-9


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _ground(n=500, seed=0):
    rng = np.random.RandomState(seed)
    lat = 11.02 + 0.02 * rng.uniform(-1, 1, n)
    lon = -72.71 + 0.03 * rng.uniform(-1, 1, n)
    alt = 50.0 + 300.0 * rng.uniform(-1, 1, n)
    return lat, lon, alt


def test_ellipsoid_roundtrip_matches_jax():
    lat, lon, alt = _ground()
    xj = np.stack([np.asarray(v) for v in jell.latlon_to_ecef(jnp.asarray(lat), jnp.asarray(lon), jnp.asarray(alt))], -1)
    xt = tell.latlon_to_ecef_arr(t(lat), t(lon), t(alt)).numpy()
    _close(xt, xj)
    gj = [np.asarray(v) for v in jell.ecef_to_latlon_arr(jnp.asarray(xj))]
    gt = [v.numpy() for v in tell.ecef_to_latlon_arr(t(xj))]
    _close(gt[0], gj[0])
    _close(gt[1], gj[1])
    # altitude = p / cos(lat) - N cancels ~6.4e6 m terms: compare within
    # 4 ulps of the ECEF magnitude (4 * 9.3e-10 m)
    _close(gt[2], gj[2], rtol=0, atol=4 * np.spacing(6.4e6))
    _close(gt[0], lat, atol=1e-8)
    _close(gt[2], alt, atol=1e-3)  # the one-pass Bowring inverse is approximate


def test_rotations_match_jax():
    rng = np.random.RandomState(3)
    pts = rng.randn(200, 3) * 1e6
    ang = rng.uniform(-0.1, 0.1, (200, 3))
    _close(trot.rotate_euler(t(pts), t(ang)).numpy(),
           np.asarray(jrot.rotate_euler(jnp.asarray(pts), jnp.asarray(ang))))
    Rt = trot.euler_angles_to_R(*[t(ang[:, i]) for i in range(3)]).numpy()
    Rj = np.asarray(jrot.euler_angles_to_R(*[jnp.asarray(ang[:, i]) for i in range(3)]))
    _close(Rt, Rj, atol=1e-15)
    # R applied to points == rotate_euler
    _close(np.einsum("kij,kj->ki", Rt, pts), trot.rotate_euler(t(pts), t(ang)).numpy(),
           rtol=1e-12, atol=1e-8)


@pytest.mark.parametrize("view", [(0.0, 0.0), (300.0, -150.0), (-212.0, 212.0)])
def test_rpc_projection_and_localization_match_jax(view):
    model_j = jdemo.make_synthetic_rpc(view_dx=view[0], view_dy=view[1])
    model_t = convert.rpc_list_from_arrays([np.asarray(f)[None] for f in model_j])[0]
    model_t = trpc.map_rpc(lambda f: torch.as_tensor(np.asarray(f, np.float64)), model_t)
    lat, lon, alt = _ground(seed=1)
    cj, rj = jrpc.rpc_projection(model_j, jnp.asarray(lon), jnp.asarray(lat), jnp.asarray(alt))
    ct, rt = trpc.rpc_projection(model_t, t(lon), t(lat), t(alt))
    _close(ct.numpy(), cj)
    _close(rt.numpy(), rj)
    lonj, latj = jrpc.rpc_localization(model_j, cj, rj, jnp.asarray(alt))
    lont, latt = trpc.rpc_localization(model_t, ct, rt, t(alt))
    _close(lont.numpy(), lonj, atol=1e-12)
    _close(latt.numpy(), latj, atol=1e-12)
    # localization inverts projection
    _close(lont.numpy(), lon, atol=1e-10)
    _close(latt.numpy(), lat, atol=1e-10)


def test_rpc_batched_basis_matches_jax():
    rng = np.random.RandomState(4)
    x, y, z = (rng.uniform(-1, 1, 100) for _ in range(3))
    for fj, ft in ((jrpc.poly20_basis, trpc.poly20_basis),
                   (jrpc.poly20_basis_dx, trpc.poly20_basis_dx),
                   (jrpc.poly20_basis_dy, trpc.poly20_basis_dy),
                   (jrpc.poly20_basis_dz, trpc.poly20_basis_dz)):
        np.testing.assert_array_equal(ft(t(x), t(y), t(z)).numpy(),
                                      np.asarray(fj(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))))
    scene = jax_scene(n_cam=7, n_pts=10)
    batched = trpc.stack_rpcs(convert.rpc_list_from_arrays(rpc_arrays(scene["rpcs"])), "cpu")
    for a, b in zip(batched, rpc_arrays(scene["rpcs"])):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("n_cam,n_pts,seed", [(8, 400, 0), (16, 2000, 3)])
def test_demo_scene_matches_jax(n_cam, n_pts, seed):
    js = jdemo.make_scene_arrays(n_cam=n_cam, n_pts=n_pts, seed=seed)
    ts = tdemo.make_scene_arrays(n_cam=n_cam, n_pts=n_pts, seed=seed, device="cpu")
    for k in ("pts_ind", "cam_ind", "weights"):
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    _close(ts["pts3d"], js["pts3d"])
    _close(ts["cam_params0"], js["cam_params0"])
    _close(ts["camera_centers"], js["camera_centers"])
    _close(ts["cam_params_true"], js["cam_params_true"])
    # pts2d: 1e-9 px plus 1e-12 of the image coordinate range. torch's CPU
    # atan2/sin/cos/sqrt and XLA's differ by up to 1 ulp; one ulp of
    # longitude is ~7e-10 px at these RPC scales, and the worst observation
    # collects two (1.5e-9 px measured at seed 0)
    span = np.abs(js["pts2d"]).max()
    assert np.abs(ts["pts2d"] - js["pts2d"]).max() <= 1e-9 + 1e-12 * span
    for a, b in zip(ts["rpcs"], rpc_arrays(js["rpcs"])):
        np.testing.assert_array_equal(a.numpy(), b)
