"""Shared helpers for the PyTorch-port parity tests, and the state-carrying
tests of sat_bundleadjust_tpu_torch.convert.

The port runs on the CPU (device="cpu"), JAX as tests/conftest.py sets it
up; data passes between them as numpy arrays. Scenes come from the JAX
package's utils/demo.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sat_bundleadjust_tpu  # noqa: F401  (enables float64 in JAX)
from sat_bundleadjust_tpu.ba.params import BAParams as JBAParams
from sat_bundleadjust_tpu.utils import demo as jdemo

from sat_bundleadjust_tpu_torch import convert
from sat_bundleadjust_tpu_torch.ba.params import BAParams as TBAParams
from sat_bundleadjust_tpu_torch.models.rpc import RPCModel

CPU = torch.device("cpu")

# one intra-op thread per test process: the suite runs in several worker
# processes, and torch's CPU reductions then sum in the same order on any
# machine
torch.set_num_threads(1)


def rpc_arrays(rpcs):
    """Stacked numpy fields of a JAX RPCModel (batched) or list of models."""
    if isinstance(rpcs, (list, tuple)) and not hasattr(rpcs, "_fields"):
        return [np.stack([np.asarray(r[i], np.float64) for r in rpcs])
                for i in range(len(RPCModel._fields))]
    return [np.asarray(f, np.float64) for f in rpcs]


def jax_state(p):
    """numpy state of a JAX BAParams, in convert.baparams_from_arrays form."""
    return {
        "rpcs": rpc_arrays(p.rpcs),
        "cam_params": p.cam_params,
        "pts3d": p.pts3d,
        "pts_ind": p.pts_ind,
        "cam_ind": p.cam_ind,
        "pts2d": p.pts2d,
        "pts2d_w": p.pts2d_w,
        "cam_opt_mask": p.cam_opt_mask,
        "pts_opt_mask": p.pts_opt_mask,
        "pairs_to_triangulate": np.asarray(p.pairs_to_triangulate).reshape(-1, 2),
        "correction_params": p.cam_params_to_optimize,
        "pts_prev_indices": p.pts_prev_indices,
        "cam_prev_indices": p.cam_prev_indices,
        "ref_cam_weight": p.ref_cam_weight,
    }


def jax_scene(n_cam=16, n_pts=1000, seed=0, obs_per_pt=4):
    return jdemo.make_scene_arrays(n_cam=n_cam, n_pts=n_pts, obs_per_pt=obs_per_pt,
                                   rot_scale=2e-5, noise_px=0.1, seed=seed)


def both_problems(scene, dense_c=False, d=None, outliers=None):
    """The same problem in both packages, from one JAX demo scene: the JAX
    BAParams and the port's BAParams built by the port's own constructor
    from the same numpy arrays. outliers=(fraction, seed) moves that share
    of the observations by 10-30 px in a random direction."""
    d = dict(d or {}, verbose=False)
    n_cam = scene["cam_params0"].shape[0]
    n_pts = scene["pts3d"].shape[0]
    pts2d = np.array(scene["pts2d"])
    if outliers is not None:
        frac, seed = outliers
        rng = np.random.RandomState(seed)
        k = rng.choice(len(pts2d), int(frac * len(pts2d)), replace=False)
        ang = rng.uniform(0, 2 * np.pi, len(k))
        mag = rng.uniform(10.0, 30.0, len(k))
        pts2d[k] += np.stack([np.cos(ang), np.sin(ang)], axis=1) * mag[:, None]
    pairs = [(i, j) for i in range(n_cam) for j in range(i + 1, n_cam)]
    pts0 = scene["pts3d"] + 1.0 * np.random.RandomState(1).randn(n_pts, 3)
    centers = [c for c in scene["camera_centers"]]
    jcams = scene["rpc_list"]
    tcams = convert.rpc_list_from_arrays(rpc_arrays(jcams))
    if dense_c:
        C = np.full((2 * n_cam, n_pts), np.nan)
        C[2 * scene["cam_ind"], scene["pts_ind"]] = pts2d[:, 0]
        C[2 * scene["cam_ind"] + 1, scene["pts_ind"]] = pts2d[:, 1]
        jp = JBAParams(C, pts0, jcams, "rpc", pairs, centers, d)
        tp = TBAParams(C, pts0, tcams, "rpc", pairs, centers, d)
    else:
        args = (scene["pts_ind"], scene["cam_ind"], pts2d, pts0)
        jp = JBAParams.from_obs_table(*args, jcams, "rpc", centers, pairs, d)
        tp = TBAParams.from_obs_table(*args, tcams, "rpc", centers, pairs, d)
    return jp, tp


def t(a, dtype=None):
    """numpy / JAX array -> CPU tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


# ----------------------------------------------------------------------
# convert.py
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dense_c", [False, True])
def test_convert_baparams_matches_port_constructor(dense_c):
    """State carried in from a JAX BAParams equals the port's own
    construction of the same problem, field by field."""
    scene = jax_scene(n_cam=6, n_pts=300)
    jp, tp = both_problems(scene, dense_c=dense_c, d={"n_cam_fix": 1, "n_pts_fix": 5})
    cp = convert.baparams_from_arrays(jax_state(jp))
    for name in ("pts_ind", "cam_ind", "pts2d", "pts2d_w", "pts3d", "cam_params",
                 "cam_opt_mask", "pts_opt_mask", "pts_prev_indices", "cam_prev_indices"):
        np.testing.assert_array_equal(getattr(cp, name), getattr(tp, name), err_msg=name)
    for name in ("n_cam", "n_pts", "n_obs", "n_params", "n_cam_fix", "n_pts_fix",
                 "pairs_to_triangulate"):
        assert getattr(cp, name) == getattr(tp, name), name
    for a, b in zip(cp.rpcs, tp.rpcs):
        assert torch.equal(a, b)


def test_convert_rpcs_from_arrays():
    scene = jax_scene(n_cam=5, n_pts=50)
    fields = rpc_arrays(scene["rpcs"])
    rpcs = convert.rpcs_from_arrays(fields, CPU)
    by_name = convert.rpcs_from_arrays(dict(zip(RPCModel._fields, fields)), CPU)
    for f, a, b in zip(fields, rpcs, by_name):
        assert a.dtype == torch.float64 and a.shape == f.shape
        np.testing.assert_array_equal(a.numpy(), f)
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        convert.rpcs_from_arrays(fields[:-1], CPU)
    # the JAX batched model and the port's agree on every field
    np.testing.assert_array_equal(np.asarray(jnp.asarray(scene["rpcs"].lat_scale)),
                                  rpcs.lat_scale.numpy())
