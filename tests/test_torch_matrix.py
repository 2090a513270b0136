"""The matrix camera models of the port (affine and perspective, with
correction_params R, T, K and COMMON_K) against the JAX package's, on the
same seeded numpy inputs, on the CPU.

Scenes: `utils/demo.make_matrix_scene` of the port (numpy): affine
cameras from `affine_rpc_approx` of `make_synthetic_rpc` views,
perspective ones from satellite pinholes (the synthetic RPCs are affine, so
their perspective fit is degenerate: a reflection in R, a centre near the
Earth's surface, parameters that do not give the camera back), cloned per
camera with the intrinsics of view 0 and perturbed angles, the
observations made by the true cameras, the solve started from perturbed
angles and points: tests/test_matrix_models.py::_matrix_scene's recipe
without the reference RPCs it reads.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sat_bundleadjust_tpu  # noqa: F401  (enables float64 in JAX)
from sat_bundleadjust_tpu.ba import params as jparams
from sat_bundleadjust_tpu.ba import rpcfit as jrpcfit
from sat_bundleadjust_tpu.ba import solver as jsolver
from sat_bundleadjust_tpu.models import cameras as jcam
from sat_bundleadjust_tpu.models import ellipsoid as jell
from sat_bundleadjust_tpu.ops import project as jproj
from sat_bundleadjust_tpu.ops import triangulate as jtri
from sat_bundleadjust_tpu.utils import demo as jdemo
from sat_bundleadjust_tpu.utils import io as jio

from test_torch_common import rpc_arrays, t

from sat_bundleadjust_tpu_torch import convert
from sat_bundleadjust_tpu_torch.ba import params as tparams
from sat_bundleadjust_tpu_torch.ba import rpcfit as trpcfit
from sat_bundleadjust_tpu_torch.ba import solver as tsolver
from sat_bundleadjust_tpu_torch.models import cameras as tcam
from sat_bundleadjust_tpu_torch.models.rpc import rpc_projection_np
from sat_bundleadjust_tpu_torch.ops import project as tproj
from sat_bundleadjust_tpu_torch.ops import triangulate as ttri
from sat_bundleadjust_tpu_torch.utils import demo as tdemo
from sat_bundleadjust_tpu_torch.utils import io as tio

OFFSET = {"col0": 0.0, "row0": 0.0, "width": 3200, "height": 1350}


def _views(n_cam):
    rpcs = [jdemo.make_synthetic_rpc(view_dx=300.0 * np.cos(2 * np.pi * i / n_cam + 0.4),
                                     view_dy=300.0 * np.sin(2 * np.pi * i / n_cam + 0.4))
            for i in range(n_cam)]
    return rpcs, convert.rpc_list_from_arrays(rpc_arrays(rpcs))


def _ground_points(rpc, n_pts, rng):
    cols = float(rpc.col_offset) + 0.4 * float(rpc.col_scale) * rng.uniform(-1, 1, n_pts)
    rows = float(rpc.row_offset) + 0.4 * float(rpc.row_scale) * rng.uniform(-1, 1, n_pts)
    alts = 30.0 + rng.uniform(0, 60, n_pts)
    lons, lats = rpc.localization(cols, rows, alts)
    return np.stack(jell.latlon_to_ecef_np(lats, lons, alts), axis=1)


def _C(s, n_cam):
    C = np.full((2 * n_cam, len(s["pts3d"])), np.nan)
    C[2 * s["cam_ind"], s["pts_ind"]] = s["pts2d"][:, 0]
    C[2 * s["cam_ind"] + 1, s["pts_ind"]] = s["pts2d"][:, 1]
    return C


def _both(cam_model, params, n_cam=4, n_pts=80, seed=0, dense_c=False):
    """The JAX package's and the port's BAParams of one make_matrix_scene
    problem (every camera sees every point), and the scene."""
    s = tdemo.make_matrix_scene(cam_model, n_cam=n_cam, n_pts=n_pts, seed=seed)
    d = {"verbose": False, "correction_params": params}
    if dense_c:
        args = (_C(s, n_cam), s["pts0"], s["cameras_init"], cam_model, s["pairs"],
                s["camera_centers"], d)
        return jparams.BAParams(*args), tparams.BAParams(*args), s
    args = (s["pts_ind"], s["cam_ind"], s["pts2d"], s["pts0"], s["cameras_init"], cam_model,
            s["camera_centers"], s["pairs"], d)
    return jparams.BAParams.from_obs_table(*args), tparams.BAParams.from_obs_table(*args), s


# ----------------------------------------------------------------------
# models/cameras.py
# ----------------------------------------------------------------------


def test_matrix_camera_helpers_match_jax():
    """decompose/compose of affine and perspective cameras,
    apply_projection_matrix, affine_rpc_approx and perspective_rpc_approx on
    synthetic RPCs: within 1e-9 relative (affine_rpc_approx's Jacobian is
    torch.func's forward mode against jax.jacfwd through libm's atan2 and
    sqrt, the libm tolerance of tests/test_torch_geometry.py), the rest
    numpy on the same inputs (1e-12 relative)."""
    jrpcs, trpcs = _views(3)
    pts = _ground_points(jrpcs[0], 50, np.random.RandomState(3))
    c = pts.mean(axis=0)
    for jr, tr in zip(jrpcs, trpcs):
        Pa_j = jcam.affine_rpc_approx(jr, c[0], c[1], c[2], OFFSET)
        Pa_t = tcam.affine_rpc_approx(tr, c[0], c[1], c[2], OFFSET)
        np.testing.assert_allclose(Pa_t, Pa_j, rtol=1e-9, atol=1e-12 * np.abs(Pa_j).max())
        Pp_j, err_j = jcam.perspective_rpc_approx(jr, OFFSET)
        Pp_t, err_t = tcam.perspective_rpc_approx(tr, OFFSET)
        np.testing.assert_allclose(Pp_t, Pp_j, rtol=1e-9, atol=1e-12 * np.abs(Pp_j).max())
        assert abs(err_t - err_j) <= 1e-9
        for got, want in zip(tcam.decompose_affine_camera(Pa_j), jcam.decompose_affine_camera(Pa_j)):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        K, R, T = tcam.decompose_affine_camera(Pa_j)
        np.testing.assert_allclose(tcam.compose_affine_camera(K, R, T),
                                   jcam.compose_affine_camera(K, R, T), rtol=1e-12)
        # the affine composition gives the camera back
        np.testing.assert_allclose(tcam.compose_affine_camera(K, R, T), Pa_j,
                                   rtol=1e-9, atol=1e-9 * np.abs(Pa_j).max())
        K, R, _, oC = tcam.decompose_perspective_camera(Pp_j)
        Pp = tcam.compose_perspective_camera(K, R, oC)
        np.testing.assert_allclose(Pp, jcam.compose_perspective_camera(K, R, oC), rtol=1e-12)
        np.testing.assert_allclose(Pp / Pp[2, 3], Pp_j, rtol=1e-7, atol=1e-9 * np.abs(Pp_j).max())
        for P in (Pa_j, Pp_j):
            np.testing.assert_allclose(tcam.apply_projection_matrix(P, pts),
                                       jcam.apply_projection_matrix(P, pts), rtol=1e-12)
        # the approximations reproduce the RPC near the ground points
        rp = np.stack(rpc_projection_np(tr, *_lonlatalt(pts)), axis=1)
        assert np.abs(tcam.apply_projection_matrix(Pp_t, pts) - rp).max() < 0.5


def _lonlatalt(pts):
    lat, lon, alt = jell.ecef_to_latlon_np(pts[:, 0], pts[:, 1], pts[:, 2])
    return lon, lat, alt


@pytest.mark.parametrize("cam_model", ["affine", "perspective"])
def test_cam_params_round_trip_matches_jax(cam_model):
    """load_cam_params_from_camera and load_camera_from_cam_params: the
    JAX package's values (1e-12 relative: the same numpy, and the rotation
    matrix from the same formulas in torch and XLA)."""
    s = tdemo.make_matrix_scene(cam_model, n_cam=3)
    for P, c in zip(s["cameras_true"], s["camera_centers"]):
        pj = jparams.load_cam_params_from_camera(P, c, cam_model)
        pt = tparams.load_cam_params_from_camera(P, c, cam_model)
        assert pt.shape == (tproj.CAM_PARAMS_SIZE[cam_model],)
        np.testing.assert_allclose(pt, pj, rtol=1e-12, atol=1e-15)
        Qj = jparams.load_camera_from_cam_params(pj, cam_model)
        Qt = tparams.load_camera_from_cam_params(pt, cam_model)
        np.testing.assert_allclose(Qt, Qj, rtol=1e-12, atol=1e-12 * np.abs(Qj).max())
        # the scene's cameras are made from parameters: they come back
        np.testing.assert_allclose(Qt, P, rtol=1e-9, atol=1e-12 * np.abs(Qj).max())


# ----------------------------------------------------------------------
# ops/project.py and the solver's Jacobians
# ----------------------------------------------------------------------


@pytest.mark.parametrize("cam_model", ["affine", "perspective"])
def test_projection_residuals_match_jax(cam_model):
    """project_affine / project_perspective residuals and reprojection
    errors: within 1e-9 px (the libm tolerance of
    tests/test_torch_geometry.py: sin/cos of the Euler angles)."""
    jp, tp, _ = _both(cam_model, ["R", "T", "K"])
    cam = tp.cam_params + 1e-4 * np.random.RandomState(4).randn(*tp.cam_params.shape)
    args = (tp.pts3d, cam, tp.pts_ind, tp.cam_ind, tp.pts2d)
    rj = np.asarray(jproj.residuals(cam_model, *(jnp.asarray(a) for a in args),
                                    jnp.asarray(tp.pts2d_w)))
    rt = tproj.residuals(cam_model, *(t(a) for a in args), t(tp.pts2d_w)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-9)
    ej = np.asarray(jproj.reprojection_error(cam_model, *(jnp.asarray(a) for a in args)))
    et = tproj.reprojection_error(cam_model, *(t(a) for a in args)).numpy()
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-9)


@pytest.mark.parametrize("cam_model,params", [
    ("affine", ["R"]), ("affine", ["R", "T", "K"]),
    ("perspective", ["R", "T"]), ("perspective", ["R", "T", "K"]),
])
def test_matrix_jacobians_match_jax_jacfwd(cam_model, params):
    """The residual and its Jacobians (torch.func.jacfwd under vmap, f64)
    against JAX's jacfwd under vmap: rtol 1e-9 (the same chain rule; sin
    and cos of the angles from two libms)."""
    jp, tp, _ = _both(cam_model, params)
    cam = tp.opt_block() + 1e-4 * np.random.RandomState(5).randn(tp.n_cam, tp.n_params)
    pts = tp.pts3d
    rj, Jcj, Jpj = (np.asarray(a) for a in jsolver.make_fns(jp)[1](jnp.asarray(cam),
                                                                  jnp.asarray(pts)))
    rt, Jct, Jpt = (a.numpy() for a in tsolver.make_fns(tp, "cpu")[1](t(cam), t(pts)))
    assert Jct.dtype == np.float64 and Jct.shape == (tp.n_obs, 2, tp.n_params)
    np.testing.assert_allclose(rt, rj, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(Jct, Jcj, rtol=1e-9, atol=1e-9 * np.abs(Jcj).max())
    np.testing.assert_allclose(Jpt, Jpj, rtol=1e-9, atol=1e-9 * np.abs(Jpj).max())


# ----------------------------------------------------------------------
# ops/triangulate.py
# ----------------------------------------------------------------------


@pytest.mark.parametrize("cam_model", ["affine", "perspective"])
def test_linear_triangulation_and_init_pts3d_match_jax(cam_model):
    """linear_triangulation and init_pts3d with matrix cameras: within 1e-9
    of the coordinates' scale (6.4e-3 m) of JAX's (two SVD implementations
    of the 4x4 DLT system, whose entries span 1e-8..1e7: measured 4.2e-3 m
    on an earlier scene) and within 1e-6 of it of the true points."""
    s = tdemo.make_matrix_scene(cam_model, n_cam=4, n_pts=60)
    C, pts3d, cams, pairs = _C(s, 4), s["pts3d"], s["cameras_true"], s["pairs"]
    obs0, obs1 = C[0:2].T, C[2:4].T
    xj = np.asarray(jtri.linear_triangulation(cams[0], cams[1], jnp.asarray(obs0),
                                              jnp.asarray(obs1)))
    xt = ttri.linear_triangulation(t(cams[0]), t(cams[1]), t(obs0), t(obs1)).numpy()
    tol = 1e-9 * np.abs(pts3d).max()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=tol)
    np.testing.assert_allclose(xt, pts3d, rtol=0, atol=1e3 * tol)
    pj = jtri.init_pts3d(C, cams, cam_model, pairs)
    pt = ttri.init_pts3d(C, cams, cam_model, pairs, device="cpu")
    np.testing.assert_allclose(pt, pj, rtol=0, atol=tol)
    np.testing.assert_allclose(pt, pts3d, rtol=0, atol=1e3 * tol)


# ----------------------------------------------------------------------
# ba/params.py + ba/solver.py + ops/lm.py
# ----------------------------------------------------------------------


@pytest.mark.parametrize("cam_model,params", [
    (m, p) for m in ("affine", "perspective")
    for p in (["R"], ["R", "T"], ["R", "T", "K"])
])
def test_matrix_solve_matches_jax(cam_model, params):
    """A solve (dense Schur on the CPU in both packages, f64 normal
    equations) from perturbed angles and points against the JAX package's
    BASolver on the same BAParams (the C-matrix constructor): the final
    mean reprojection error within 1e-3 px of JAX's and below 1e-3 px (from
    2.5-4.4 px), the iterations within 2, R within 1e-6 rad, T and K
    within 1e-7 of their block's scale (R T K: LM stops at nearby points of
    the gauge's flat valley; measured 1e-8 of it), the corrected matrices
    projecting within 1e-3 px of JAX's."""
    jp, tp, _ = _both(cam_model, params, dense_c=True)
    assert tp.n_params == jp.n_params and tp.n_params_k == jp.n_params_k
    np.testing.assert_allclose(tp.cam_params, jp.cam_params, rtol=1e-12, atol=1e-15)
    _, (cj, pj), e0j, ej, itj = jsolver.run_ba_optimization(jp, {"max_iter": 40})
    _, (ct, pt), e0t, et, itt = tsolver.run_ba_optimization(tp, {"max_iter": 40}, device="cpu")
    cj, ct = np.asarray(cj), ct.numpy()
    assert abs(float(np.mean(et)) - float(np.mean(ej))) <= 1e-3
    assert float(np.mean(et)) < 1e-3 < 1.0 < float(np.mean(e0t)), (np.mean(e0t), np.mean(et))
    assert abs(itt - itj) <= 2, (itt, itj)
    # R in rad; T and K against their block's scale (skew, cx and cy are
    # weakly determined, their scale that of the focal)
    k0 = tp.n_params - tp.n_params_k
    for b in (slice(0, 3), slice(3, k0), slice(k0, tp.n_params)):
        if b.stop > b.start:
            tol = 1e-6 if b.start == 0 else 1e-7 * np.abs(cj[:, b]).max()
            assert np.abs(ct[:, b] - cj[:, b]).max() <= tol, (b, np.abs(ct - cj).max(axis=0))
    # reconstruct_vars: the corrected matrices project as JAX's
    qt = tp.reconstruct_vars(ct, pt, tp.pts3d, tp.cameras)[1]
    qj = jp.reconstruct_vars(cj, pj, jp.pts3d, jp.cameras)[1]
    for a, b in zip(qt, qj):
        assert a.shape == (3, 4)
        np.testing.assert_allclose(jcam.apply_projection_matrix(a, tp.pts3d),
                                   jcam.apply_projection_matrix(b, tp.pts3d), rtol=0, atol=1e-3)


@pytest.mark.parametrize("cam_model", ["affine", "perspective"])
def test_common_k_ties_k_and_matches_jax(cam_model):
    """COMMON_K: K seeded from camera 0; after the solve (CG with the tied
    tail in both packages: the port's plain f64-camera-sum operator, JAX's
    f32 "aos" one, so they stop at other points: measured T 3 m and K 2e-5
    relative apart) the optimized cameras' K equal to 1e-12 relative; the
    final mean error within 1e-3 px of JAX's and below 1e-3 px."""
    params = ["R", "T", "K", "COMMON_K"]
    jp, tp, _ = _both(cam_model, params)
    k = tp.n_params_k
    assert tp.common_k and k == (3 if cam_model == "affine" else 5)
    k0 = tp.cam_params[:, tp.n_params - k: tp.n_params]
    assert np.all(k0 == k0[0])
    solver = tsolver.BASolver(tp, device="cpu")
    cfg = solver.config({"max_iter": 40})
    assert cfg.tie_tail == k and cfg.schur_mode == "cg"
    _, (cj, _), _, ej, _ = jsolver.run_ba_optimization(jp, {"max_iter": 40})
    _, (ct, _), e0t, et, _ = tsolver.run_ba_optimization(tp, {"max_iter": 40}, solver=solver)
    K = ct.numpy()[:, tp.n_params - k: tp.n_params]
    assert np.all(np.abs(K - K[0]) <= 1e-12 * np.abs(K[0]))
    assert abs(float(np.mean(et)) - float(np.mean(ej))) <= 1e-3
    assert float(np.mean(et)) < 1e-3 < 1.0 < float(np.mean(e0t))
    assert solver.last_info["matvecs"] > 0


def test_common_k_projector_averages_the_optimized_cameras():
    """The tied-tail projector: the tail of the optimized cameras becomes
    their mean, frozen cameras keep theirs, the head is untouched; it is a
    projector (idempotent)."""
    from sat_bundleadjust_tpu_torch.ops.lm import tied_tail_projector

    x = torch.randn(5, 11, generator=torch.Generator().manual_seed(0))
    m = torch.tensor([0.0, 1.0, 1.0, 0.0, 1.0])[:, None]
    proj = tied_tail_projector(m, 11, 5)
    y = proj(x)
    assert torch.equal(y[:, :6], x[:, :6])
    assert torch.equal(y[[0, 3], 6:], x[[0, 3], 6:])
    mean = x[[1, 2, 4], 6:].sum(0) / 3
    for i in (1, 2, 4):
        torch.testing.assert_close(y[i, 6:], mean, rtol=0, atol=1e-6)
    assert torch.equal(proj(y), y)
    assert tied_tail_projector(m, 11, 0)(x) is x


def test_convert_carries_matrix_baparams():
    """convert.baparams_from_arrays with matrix cameras gives the port's own
    construction, field by field."""
    jp, tp, _ = _both("perspective", ["R", "T", "K", "COMMON_K"], dense_c=True)
    cp = convert.baparams_from_arrays({
        "cam_model": "perspective", "cameras": np.stack(jp.cameras),
        "camera_centers": np.stack(jp.camera_centers),
        "cam_params": jp.cam_params, "pts3d": jp.pts3d, "pts_ind": jp.pts_ind,
        "cam_ind": jp.cam_ind, "pts2d": jp.pts2d, "pts2d_w": jp.pts2d_w,
        "cam_opt_mask": jp.cam_opt_mask, "pts_opt_mask": jp.pts_opt_mask,
        "pairs_to_triangulate": np.asarray(jp.pairs_to_triangulate),
        "correction_params": jp.cam_params_to_optimize,
    })
    for name in ("pts_ind", "cam_ind", "pts2d", "pts3d", "cam_opt_mask", "pts_opt_mask"):
        np.testing.assert_array_equal(getattr(cp, name), getattr(tp, name), err_msg=name)
    np.testing.assert_allclose(cp.cam_params, tp.cam_params, rtol=1e-12, atol=1e-15)
    for name in ("n_params", "n_params_k", "common_k", "rpcs"):
        assert getattr(cp, name) == getattr(tp, name), name


# ----------------------------------------------------------------------
# ba/rpcfit.py and utils/io.py
# ----------------------------------------------------------------------


@pytest.mark.parametrize("cam_model", ["affine", "perspective"])
def test_fit_rpc_from_projection_matrix_matches_jax(cam_model):
    """The RPC refit of a corrected matrix: the same margin, the fit error
    per grid point within 1e-6 px of JAX's (the bar of
    tests/test_torch_rpcfit.py) and below 1e-2 px (a cubic RPC over +-8 km
    of altitude copying a matrix in ECEF: 3.1e-3 px measured for affine,
    the JAX package's own fit error), and the fitted RPCs within 1e-3 px
    of each other on a ground grid."""
    s = tdemo.make_matrix_scene(cam_model, n_cam=2)
    pts3d, cams = s["pts3d"], s["cameras_true"]
    jrpcs, trpcs = _views(2)
    gt = np.array([0.3, -0.2, 0.1])
    rj, errj, mj = jrpcfit.fit_rpc_from_projection_matrix(cams[1], gt, jrpcs[1], OFFSET, pts3d)
    rt, errt, mt = trpcfit.fit_rpc_from_projection_matrix(cams[1], gt, trpcs[1], OFFSET, pts3d)
    assert mt == mj
    np.testing.assert_allclose(errt, errj, rtol=0, atol=1e-6)
    assert errt.max() < 1e-2
    lon, lat, alt = _lonlatalt(pts3d)
    gj = np.stack(rpc_projection_np(convert.rpc_list_from_arrays(rpc_arrays([rj]))[0],
                                    lon, lat, alt), axis=1)
    gt_ = np.stack(rpc_projection_np(rt, lon, lat, alt), axis=1)
    assert np.abs(gt_ - gj).max() < 1e-3
    # and the fit copies the matrix
    want = jcam.apply_projection_matrix(cams[1], pts3d + gt)
    assert np.abs(gt_ - want).max() < 1e-2


def test_save_projection_matrices_json_equal(tmp_path):
    cams = tdemo.make_matrix_scene("perspective", n_cam=2)["cameras_true"]
    offs = [dict(OFFSET, col0=3.0), dict(OFFSET, row0=7.0)]
    fj = [str(tmp_path / "j{}.json".format(i)) for i in range(2)]
    ft = [str(tmp_path / "t{}.json".format(i)) for i in range(2)]
    jio.save_projection_matrices(fj, cams, offs)
    tio.save_projection_matrices(ft, cams, offs)
    for a, b in zip(fj, ft):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
        assert json.load(open(b))["col_offset"] in (0, 3)
    assert os.path.getsize(ft[0]) > 0


# ----------------------------------------------------------------------
# the pipeline with cam_model "perspective"
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def perspective_runs(tmp_path_factory):
    """Four 150x200 views rendered through RPCs fitted to satellite pinholes
    (utils/demo.pinhole_rpc; so that the pipeline's perspective
    approximation is well posed), biases of up to +-3 px on cameras 1-3;
    both packages' `main` with cam_model "perspective", correction_params
    R, bruteforce matching, FT_kp_max 1500, save_figures False."""
    from PIL import Image

    import sat_bundleadjust_tpu
    from sat_bundleadjust_tpu.models.rpc import rpc_from_rpc_file as jread

    import sat_bundleadjust_tpu_torch
    from sat_bundleadjust_tpu_torch.models.rpc import write_rpc_file

    from test_e2e import render_image, world_texture

    root = tmp_path_factory.mktemp("torch_perspective")
    img_dir = root / "images"
    img_dir.mkdir()
    tex = world_texture()
    h, w = 150, 200
    rng = np.random.RandomState(11)
    for i in range(4):
        a = 2 * np.pi * i / 4 + 0.3
        P = tdemo.satellite_pinhole(view=(1e5 * np.cos(a), 1e5 * np.sin(a)), gsd=32.0,
                                    img_halfsize=(w / 2, h / 2))
        rpc = tdemo.pinhole_rpc(P)
        name = "20200413_1514{:02d}_pinhole_cam{}".format(10 + i, i)
        write_rpc_file(rpc, str(img_dir / (name + ".rpc")))
        im = render_image(jread(str(img_dir / (name + ".rpc"))), tex, h, w)
        Image.fromarray(im).save(str(img_dir / (name + ".tif")))
        bias = np.zeros(2) if i == 0 else rng.uniform(-3, 3, 2)
        write_rpc_file(rpc._replace(col_offset=rpc.col_offset + bias[0],
                                    row_offset=rpc.row_offset + bias[1]),
                       str(img_dir / (name + ".rpc")))
    out = {}
    for pkg in ("jax", "torch"):
        cfg = {"geotiff_dir": str(img_dir), "rpc_dir": str(img_dir), "rpc_src": "txt",
               "output_dir": str(root / ("out_" + pkg)), "cam_model": "perspective",
               "correction_params": ["R"], "FT_kp_max": 1500, "FT_sift_detection": "tpu",
               "FT_sift_matching": "bruteforce", "save_figures": False}
        scene = (sat_bundleadjust_tpu.main(cfg) if pkg == "jax"
                 else sat_bundleadjust_tpu_torch.main(cfg, device="cpu"))
        scene.ba_pipeline.save_initial_matrices()
        out[pkg] = os.path.join(cfg["output_dir"], "ba_bruteforce")
        out[pkg + "_err"] = (float(np.mean(scene.ba_pipeline.init_e)),
                             float(np.mean(scene.ba_pipeline.ba_e)))
    return out


def _json_matrices(d, sub):
    names = sorted(os.listdir(os.path.join(d, sub)))
    return names, [json.load(open(os.path.join(d, sub, n))) for n in names]


def test_perspective_pipeline_matches_jax(perspective_runs):
    """P_init/ (save_initial_matrices: JAX's run never calls it, so both
    pipelines are asked after the run) equal to 1e-9 relative (the same
    host perspective fit); P_adj/ projecting the tracks' ground within 1e-3
    px of JAX's; the .rpc_adj files projecting a ground grid within 1e-2 px
    of JAX's (tests/test_torch_e2e.py's bar), four of each; the port's
    solve halves the mean reprojection error, as JAX's."""
    from sat_bundleadjust_tpu_torch.models.rpc import rpc_from_rpc_file

    for pkg in ("jax", "torch"):
        init_e, ba_e = perspective_runs[pkg + "_err"]
        assert ba_e < 0.5 * init_e, (pkg, init_e, ba_e)

    oj, ot = perspective_runs["jax"], perspective_runs["torch"]
    for sub in ("P_init", "P_adj"):
        nj, dj = _json_matrices(oj, sub)
        nt, dt = _json_matrices(ot, sub)
        assert nt == nj and len(nt) == 4
        for a, b in zip(dt, dj):
            assert {k: a[k] for k in a if k != "P"} == {k: b[k] for k in b if k != "P"}
            Pa, Pb = np.array(a["P"]), np.array(b["P"])
            if sub == "P_init":
                np.testing.assert_allclose(Pa, Pb, rtol=1e-9, atol=1e-9 * np.abs(Pb).max())
            else:
                pts = _ground_points(jdemo.make_synthetic_rpc(), 30, np.random.RandomState(0))
                assert np.abs(jcam.apply_projection_matrix(Pa, pts)
                              - jcam.apply_projection_matrix(Pb, pts)).max() <= 1e-3
    fj = sorted(os.listdir(os.path.join(oj, "rpcs_adj")))
    assert sorted(os.listdir(os.path.join(ot, "rpcs_adj"))) == fj and len(fj) == 4
    LO, LA = np.meshgrid(-72.71 + np.linspace(-0.01, 0.01, 7), 11.02 + np.linspace(-0.008, 0.008, 7))
    alts = np.full(LO.size, 50.0)
    for n in fj:
        gj, gt = (np.stack(rpc_projection_np(rpc_from_rpc_file(os.path.join(o, "rpcs_adj", n)),
                                             LO.ravel(), LA.ravel(), alts), axis=1)
                  for o in (oj, ot))
        assert np.abs(gt - gj).max() <= 1e-2, np.abs(gt - gj).max()
