"""Parity of the port's remaining public functions with the JAX package's,
on the CPU: the rotation conversions (models/rotations.py), RPCModel's
methods (models/rpc.py), the single-pair affine F (tracks/matching.py),
detect_tpu (tracks/detection.py) and DistributedLM.cost
(parallel/dist_solver.py). The same numpy inputs, made from seeds, go to
both packages.

Tolerances: the rotations are float64 arithmetic through sin, cos, atan2,
asin and sqrt, whose last bits differ between torch's and XLA's CPU
libraries (ROADMAP Queue 3, "libm last bits"; measured here within 4.5e-16),
so they agree to 1e-12. The RPC methods and the F are the same numpy code on
both sides (equal to 1e-12 of their scale; the files byte for byte).
detect_tpu has tests/test_torch_sift.py's CPU SIFT bars but one, stated at
the test. The cost agrees to 1e-12 relative.

Run as a program, this file is one rank's worker of the two-rank cost test:
    python tests/test_torch_api.py <rank> <world> <port> <out.npy>
"""

import os
import sys

import numpy as np
import pytest
import torch

ROT_TOL = 1e-12
LS = {"loss": "soft_l1", "f_scale": 2.0, "max_iter": 3}

R_FIXED = np.array([
    [0.25538431, -0.96424759, -0.07074919],
    [0.86330366, 0.19447877, 0.46570891],
    [-0.43529948, -0.18001279, 0.8821053],
])


def _rotations():
    """Rotation matrices: the JAX tests' R_FIXED, 30 random ones, one with
    pitch +pi/2 (singular: R[0, 0] = R[1, 0] = 0) and the identity (axis-angle
    with r = 0)."""
    from sat_bundleadjust_tpu_torch.models.rotations import euler_angles_to_R

    rng = np.random.RandomState(0)
    angles = rng.uniform(-np.pi, np.pi, (30, 3))
    angles[:, 1] /= 2
    Rs = euler_angles_to_R(*torch.as_tensor(angles).unbind(1)).numpy()
    singular = euler_angles_to_R(*torch.tensor([0.3, np.pi / 2, -0.2], dtype=torch.float64))
    return np.concatenate([R_FIXED[None], Rs, singular.numpy()[None], np.eye(3)[None]])


def _unit_quaternions(n=30, seed=1):
    q = np.random.RandomState(seed).randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # the pitch's sine rounded past 1: quaternion_to_euler's clip
    q = np.concatenate([q, [[np.sqrt(0.5), 0.0, np.sqrt(0.5) * (1 + 1e-15), 0.0]]])
    return tuple(q.T)


def _rotation_args(name):
    rng = np.random.RandomState(2)
    if name == "rotate_rodrigues":
        aa = rng.uniform(-0.5, 0.5, (20, 3))
        aa[:3] = 0.0  # theta = 0: the point unchanged
        return rng.randn(20, 3), aa
    if name == "euler_to_quaternion":
        angles = rng.uniform(-np.pi, np.pi, (20, 3))
        angles[0, 1], angles[1, 1] = np.pi / 2, -np.pi / 2
        return tuple(angles.T)
    if name in ("quaternion_to_euler", "quaternion_to_R"):
        return _unit_quaternions()
    if name in ("R_to_quaternion", "axis_angle_from_R"):
        return (_rotations(),)
    axis = rng.randn(20, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(-np.pi, np.pi, 20)
    angle[0] = 0.0
    return axis, angle


ROTATION_FUNCTIONS = ["rotate_rodrigues", "euler_to_quaternion", "quaternion_to_euler",
                      "quaternion_to_R", "R_to_quaternion", "axis_angle_from_R",
                      "axis_angle_to_R"]


@pytest.mark.parametrize("name", ROTATION_FUNCTIONS)
def test_rotation_function_matches_jax(name):
    """Each conversion on the same float64 batch (including theta = 0 and the
    singular pitch) agrees with JAX's within ROT_TOL; the round trips of
    tests/test_rotations_cameras.py hold on the port."""
    import jax.numpy as jnp

    import sat_bundleadjust_tpu  # noqa: F401  (enables float64 in JAX)
    from sat_bundleadjust_tpu.models import rotations as jrot

    from sat_bundleadjust_tpu_torch.models import rotations as trot

    args = _rotation_args(name)
    want = getattr(jrot, name)(*[jnp.asarray(a) for a in args])
    got = getattr(trot, name)(*[torch.as_tensor(a) for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.is_tensor(g) and g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ROT_TOL)

    R = torch.as_tensor(_rotations())
    if name == "R_to_quaternion":
        np.testing.assert_allclose(trot.quaternion_to_R(*got).numpy(), R.numpy(), atol=1e-12)
    if name == "axis_angle_from_R":
        back = trot.axis_angle_to_R(*got).numpy()
        np.testing.assert_allclose(back[:-1], R.numpy()[:-1], atol=1e-12)
    if name == "rotate_rodrigues":
        pts, aa = (torch.as_tensor(a) for a in args)
        theta = torch.linalg.norm(aa, dim=1)
        for i in range(len(pts)):
            Ri = (torch.eye(3, dtype=torch.float64) if theta[i] == 0 else
                  trot.axis_angle_to_R(aa[i] / theta[i], theta[i]))
            np.testing.assert_allclose(got[0][i].numpy(), (Ri @ pts[i]).numpy(), atol=1e-12)


def test_rotations_stay_on_their_device_and_take_arrays():
    """A matrix given as a numpy array goes to the device asked for; the
    default device is the card, which may be absent (then it raises)."""
    from sat_bundleadjust_tpu_torch.models import rotations as trot

    qw, _, _, _ = trot.R_to_quaternion(R_FIXED, device="cpu")
    axis, theta = trot.axis_angle_from_R(R_FIXED, device="cpu")
    assert qw.device.type == axis.device.type == theta.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trot.R_to_quaternion(R_FIXED)


RPC_METHODS = ["projection", "localization", "to_numpy", "copy", "write_to_file",
               "to_geotiff_dict"]


@pytest.mark.parametrize("fields", ["numpy", "tensor"])
@pytest.mark.parametrize("method", RPC_METHODS)
def test_rpc_method_matches_jax(method, fields, tmp_path):
    """RPCModel's methods on utils/demo.make_synthetic_rpc against the JAX
    model's on the same numbers, with the port's fields as numpy arrays or
    as tensors: projection and localization within 1e-12 of their scale,
    to_numpy and to_geotiff_dict equal, write_to_file byte-identical, and a
    copy that equals the model and shares no storage with it."""
    import jax.numpy as jnp

    import sat_bundleadjust_tpu  # noqa: F401
    from sat_bundleadjust_tpu.models.rpc import RPCModel as JRPCModel

    from sat_bundleadjust_tpu_torch.models.rpc import RPCModel, map_rpc
    from sat_bundleadjust_tpu_torch.utils import demo

    rpc = demo.make_synthetic_rpc(view_dx=150.0, view_dy=-80.0)
    jrpc = JRPCModel(*[jnp.asarray(np.asarray(f, np.float64)) for f in rpc])
    if fields == "tensor":
        rpc = map_rpc(lambda f: torch.as_tensor(np.asarray(f, np.float64)), rpc)
    assert isinstance(rpc, RPCModel)
    rng = np.random.RandomState(3)
    lon = float(jrpc.lon_offset) + float(jrpc.lon_scale) * rng.uniform(-0.9, 0.9, 50)
    lat = float(jrpc.lat_offset) + float(jrpc.lat_scale) * rng.uniform(-0.9, 0.9, 50)
    alt = float(jrpc.alt_offset) + float(jrpc.alt_scale) * rng.uniform(-0.9, 0.9, 50)

    if method in ("projection", "localization"):
        if method == "projection":
            args = (lon, lat, alt)
        else:
            args = tuple(np.asarray(v) for v in jrpc.projection(lon, lat, alt)) + (alt,)
        got = getattr(rpc, method)(*args)
        want = getattr(jrpc, method)(*args)
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray)
            np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                       atol=1e-12 * np.abs(np.asarray(w)).max())
    elif method == "to_numpy":
        got = rpc.to_numpy()
        assert isinstance(got, RPCModel)
        for g, w in zip(got, jrpc.to_numpy()):
            assert isinstance(g, np.ndarray) and np.array_equal(g, np.asarray(w))
    elif method == "copy":
        got = rpc.copy()
        assert isinstance(got, RPCModel)
        for g, f, w in zip(got, rpc, jrpc.copy()):
            assert np.array_equal(np.asarray(g), np.asarray(w))
            if torch.is_tensor(f):
                assert torch.is_tensor(g) and g.data_ptr() != f.data_ptr()
            else:
                assert not np.shares_memory(g, f)
    elif method == "write_to_file":
        rpc.write_to_file(str(tmp_path / "port.rpc"))
        jrpc.write_to_file(str(tmp_path / "jax.rpc"))
        with open(tmp_path / "port.rpc", "rb") as a, open(tmp_path / "jax.rpc", "rb") as b:
            assert a.read() == b.read()
    else:
        assert rpc.to_geotiff_dict() == jrpc.to_geotiff_dict()


def _f_scene():
    """tests/test_sift_match.py's three views (300x400) and pairs, as port
    SatelliteImages, with the same RPCs as JAX models."""
    import jax.numpy as jnp

    import sat_bundleadjust_tpu  # noqa: F401
    from sat_bundleadjust_tpu.models.rpc import RPCModel as JRPCModel

    from sat_bundleadjust_tpu_torch.models.cameras import SatelliteImage
    from sat_bundleadjust_tpu_torch.utils.demo import make_synthetic_rpc

    h, w = 300, 400
    ims, jrpcs = [], []
    for k in range(3):
        rpc = make_synthetic_rpc(view_dx=200.0 * np.cos(2.1 * k), view_dy=200.0 * np.sin(2.1 * k),
                                 img_halfsize=(w / 2.0, h / 2.0))
        ims.append(SatelliteImage("im{}.tif".format(k), rpc,
                                  offset={"col0": 0, "row0": 0, "height": h, "width": w}))
        jrpcs.append(JRPCModel(*[jnp.asarray(np.asarray(f, np.float64)) for f in rpc]))
    return h, w, ims, jrpcs, [(0, 1), (0, 2), (1, 2)]


def _normalized(F, ref):
    F = F / np.linalg.norm(F)
    return -F if np.sum(F * ref) < 0 else F


@pytest.mark.parametrize("which", ["affine_fundamental_matrix", "init_F_pair_to_match"])
def test_single_pair_F_matches_jax_and_the_batched_F(which):
    """affine_fundamental_matrix on the same virtual matches equals JAX's;
    init_F_pair_to_match of each pair equals JAX's and the port's
    init_F_pairs_batched, F normalized and sign-aligned, within 1e-9 (JAX's
    own bar between its two, tests/test_sift_match.py:147-176)."""
    from sat_bundleadjust_tpu.tracks import matching as jmatching

    from sat_bundleadjust_tpu_torch.tracks import matching as tmatching

    h, w, ims, jrpcs, pairs = _f_scene()
    if which == "affine_fundamental_matrix":
        matches = np.random.RandomState(4).uniform(0, 400, (125, 4))
        matches[:, 2:] += 0.3 * matches[:, :2]
        got = tmatching.affine_fundamental_matrix(matches)
        np.testing.assert_allclose(got, jmatching.affine_fundamental_matrix(matches),
                                   rtol=0, atol=1e-12 * np.abs(got).max())
        return
    batched = tmatching.init_F_pairs_batched(pairs, ims)
    for (i, j), Fb in zip(pairs, batched):
        Fs = tmatching.init_F_pair_to_match(h, w, ims[i].rpc, ims[j].rpc)
        Fj = jmatching.init_F_pair_to_match(h, w, jrpcs[i], jrpcs[j])
        ref = Fb / np.linalg.norm(Fb)
        np.testing.assert_allclose(_normalized(Fs, ref), ref, atol=1e-9)
        np.testing.assert_allclose(_normalized(Fs, ref), _normalized(np.asarray(Fj), ref),
                                   atol=1e-9)


DESC_EQUAL_256 = 0.98


def test_detect_tpu_with_a_mask_matches_jax():
    """detect_tpu on a 256x256 render with a mask over its central half,
    against JAX's detect_tpu: counts within 1% and 99% of JAX's keypoints
    within 0.01 px of one of the port's (tests/test_torch_sift.py's bars),
    none of their descriptors off by more than 1, and every kept keypoint
    inside the mask by _apply_mask's rule (the truncated position).

    Equal descriptors: at least DESC_EQUAL_256 of them, not
    test_torch_sift.py's 99% (measured on its 150x200 renders). Measured on
    this frame: 98.6% with the mask, 97.8% on the whole frame, the same as
    the earlier port SIFT gave (97.8%): the last bits of XLA's float32
    atan2, sin, cos and exp differ from the port's, so an orientation or a
    bin near a rounding boundary moves by one (ROADMAP Queue 3)."""
    from scipy.spatial import cKDTree

    from sat_bundleadjust_tpu.tracks.detection import detect_tpu as jdetect
    from sat_bundleadjust_tpu_torch.tracks.detection import detect_tpu
    from sat_bundleadjust_tpu_torch.utils.demo import render_synthetic_images

    torch.set_num_threads(1)
    ims, _ = render_synthetic_images(n_cam=1, h=256, w=256, seed=0, alt=0.0, device="cpu")
    mask = np.zeros((256, 256), np.uint8)
    mask[64:192, 64:192] = 1
    ft = detect_tpu(ims[0], mask=mask, device="cpu")
    fj = np.asarray(jdetect(ims[0], mask=mask))
    assert fj.shape[0] > 100 and abs(ft.shape[0] - fj.shape[0]) <= 0.01 * fj.shape[0]
    cols, rows = ft[:, 0].astype(np.int64), ft[:, 1].astype(np.int64)
    assert np.all(mask[rows, cols] > 0)
    near = cKDTree(ft[:, :2]).query_ball_point(fj[:, :2], 0.01)
    found = np.array([len(c) > 0 for c in near])
    diff = np.array([np.abs(ft[c, 4:] - fj[i, 4:]).max(1).min() for i, c in enumerate(near) if c])
    assert found.mean() >= 0.99 and diff.max() <= 1.0
    assert (diff == 0).mean() >= DESC_EQUAL_256, (diff == 0).mean()


def _cost_problem():
    """A 10-camera rpc problem (the port's utils/demo.py, one seed) as the
    port's BAParams, its numpy inputs and a perturbed start."""
    from sat_bundleadjust_tpu_torch.utils import demo

    scene = demo.make_scene_arrays(n_cam=10, n_pts=400, rot_scale=2e-5, noise_px=0.1, seed=0,
                                   device="cpu")
    p = demo.scene_to_baparams(scene)
    rng = np.random.RandomState(5)
    cam = p.opt_block() + 1e-5 * rng.randn(*p.opt_block().shape)
    pts = p.pts3d + 0.5 * rng.randn(*p.pts3d.shape)
    return p, scene, cam, pts


def _jax_cost():
    """The JAX package's DistributedLM.cost of the same problem and point on
    one device."""
    import test_torch_distributed as ttd

    from sat_bundleadjust_tpu.parallel.dist_solver import make_distributed_solver
    from sat_bundleadjust_tpu.parallel.mesh import make_mesh

    _, scene, cam, pts = _cost_problem()
    jp = ttd.jax_problem("rpc", scene)
    return make_distributed_solver(jp, dict(LS), mesh=make_mesh(n_devices=1)).cost(cam, pts)


def _cost_worker(rank, world, port, out):
    """One rank: the port's DistributedLM of the problem, its cost."""
    import torch.distributed as dist

    from sat_bundleadjust_tpu_torch.parallel import multihost
    from sat_bundleadjust_tpu_torch.parallel.dist_solver import make_distributed_solver
    from sat_bundleadjust_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    multihost.initialize("127.0.0.1:" + port, int(world), int(rank), backend="gloo")
    p, _, cam, pts = _cost_problem()
    solver = make_distributed_solver(p, dict(LS), mesh=make_mesh(device="cpu"))
    np.save(out, np.array([solver.cost(cam, pts), solver.cost(torch.as_tensor(cam), pts)]))
    dist.destroy_process_group()


def test_distributed_cost_matches_jax(tmp_path):
    """DistributedLM.cost: in this process (no process group: a mesh of one
    rank) and on each of two gloo ranks (shards summed by one all-reduce),
    a float equal on every rank and within 1e-12 relative of the JAX
    package's cost on one device; cost does not count in a solve's
    all-reduces."""
    from test_torch_ranks import run_ranks

    from sat_bundleadjust_tpu_torch.parallel.dist_solver import make_distributed_solver
    from sat_bundleadjust_tpu_torch.parallel.mesh import make_mesh

    procs_out = str(tmp_path / "rank")
    run_ranks(__file__, [procs_out], 2, timeout=120)
    want = float(_jax_cost())
    p, _, cam, pts = _cost_problem()
    solver = make_distributed_solver(p, dict(LS), mesh=make_mesh(device="cpu"))
    one = solver.cost(cam, pts)
    assert isinstance(one, float)
    ranks = [np.load("{}{}.npy".format(procs_out, r)) for r in range(2)]
    assert np.array_equal(ranks[0], ranks[1]) and ranks[0][0] == ranks[0][1]
    for got in (one, float(ranks[0][0])):
        assert abs(got - want) <= 1e-12 * abs(want), (got, want)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    rank, world, port, prefix = sys.argv[1:]
    _cost_worker(rank, world, port, "{}{}.npy".format(prefix, rank))
