"""The Schur CG operator of the port (ops/schur_matvec.py) against the JAX
package's: its plain version against the wide-accumulator twin and the
Pallas kernel in interpret mode, the operator's properties, the wrapper's
input checks, and the guarded coarse inverse. The CUDA kernel itself is
compared with the plain version on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_common import both_problems, jax_scene, t
from test_torch_cuda import SCHUR_EDGE_CASES, schur_kernel_order, schur_operands

from sat_bundleadjust_tpu.ba import solver as jsolver
from sat_bundleadjust_tpu.ops import lm as jlm
from sat_bundleadjust_tpu.ops import pallas_matvec as pmv

from sat_bundleadjust_tpu_torch.ba import solver as tsolver
from sat_bundleadjust_tpu_torch.ops import lm as tlm
from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv


def _wz_system(n_cam, n_pts, seed=0, drop=0):
    """W (K, P, 3) and damped V^-1 (N, 3, 3) in f32 at the start of a solve
    (from the JAX package), and both packages' problems. drop: number of
    observations removed at random, so that tracks and cameras get ragged
    lengths and the layouts sentinel slots."""
    scene = jax_scene(n_cam=n_cam, n_pts=n_pts, seed=seed)
    if drop:
        keep = np.ones(len(scene["pts_ind"]), bool)
        keep[np.random.RandomState(seed).choice(keep.size, drop, replace=False)] = False
        scene = dict(scene, **{k: scene[k][keep] for k in ("pts_ind", "cam_ind", "pts2d")})
    jp, tp = both_problems(scene)
    js = jsolver.BASolver(jp, schur_mode="cg")
    M, N = jp.n_cam, jp.n_pts
    r, J_cam, J_pt = js.jac_fn(jnp.asarray(jp.opt_block()), jnp.asarray(jp.pts3d))
    cfg = jlm.LMConfig(schur_mode="cg")
    _, _, _, _, V, W = jlm._normal_blocks(r, J_cam, J_pt, js.prob, M, N, cfg)
    Vinv = jlm._inv3x3(jlm._damp(V, 1e-4)).astype(jnp.float32)
    W = W.astype(jnp.float32)
    tprob, _ = tsolver.build_problem(tp, "cpu", "cg")
    W_pt, W_cm = tlm.fold_layouts(t(W), t(Vinv), tprob)
    return dict(W=W, Vinv=Vinv, jprob=js.prob, tprob=tprob, W_pt=W_pt, W_cm=W_cm,
                M=M, N=N, P=jp.n_params)


def _plain(s, x):
    return smv.schur_wz_plain(t(x), s["W_pt"], s["tprob"].cam_ind_pt, s["W_cm"],
                              s["tprob"].pts_ind_cam).numpy()


_SYSTEMS = [(37, 900, 300, 128), (70, 1200, 0, 128)]


@pytest.mark.parametrize("impl,n_cam,n_pts,drop,block", [
    *(pytest.param("plain", *c, id="-".join(map(str, c))) for c in _SYSTEMS),
    *(pytest.param("kernel_order", *c, id="kernel_order-" + "-".join(map(str, c)))
      for c in _SYSTEMS),
])
def test_plain_matches_jax_twin_and_pallas_interpret(impl, n_cam, n_pts, drop, block):
    """The plain version, and the numpy model of the CUDA kernels' order of
    work, against the JAX package's f64 twin and its Pallas kernel in
    interpret mode on the same inputs."""
    s = _wz_system(n_cam, n_pts, drop=drop)
    x = np.random.default_rng(1).normal(size=(s["M"], s["P"])).astype(np.float32)
    Wh, c, meta = pmv.build_wh_operands(s["W"], s["Vinv"], s["jprob"], s["M"], block_pts=block)
    f64 = np.asarray(pmv.schur_wz_twin(jnp.asarray(x), Wh, c, meta, accum="f64"))
    pal = np.asarray(pmv.schur_wz(jnp.asarray(x), Wh, c, meta, interpret=True))
    wz = _plain(s, x)
    if impl == "kernel_order":
        plain = wz
        wz, _ = schur_kernel_order(x, s["W_pt"].numpy(), s["tprob"].cam_ind_pt.numpy(),
                                   s["W_cm"].numpy(), s["tprob"].pts_ind_cam.numpy())
        assert np.abs(wz - plain).max() <= 2e-6 * np.abs(plain).max()
    assert wz.dtype == np.float32 and wz.shape == (s["M"], s["P"])
    scale = np.abs(f64).max()
    # the same f32 products and f64 camera sums; only the f32 per-track sum
    # order (3 terms in the fold, up to Tp in the track) differs
    assert np.abs(wz - f64).max() <= 2e-6 * scale
    # the Pallas kernel's bound against the XLA matvec (f32 sums in other
    # orders, bf16-split crossings): tests/test_pallas_matvec.py
    assert np.abs(wz - pal).max() <= 3e-5 * scale


@pytest.mark.parametrize("P", [8, 10, 11])
def test_wide_camera_blocks_match_jax_twin_and_reference(P):
    """P = 8 (affine R, T, K), 10 and 11 (perspective R, T, K): the plain
    version and the numpy model of the kernels' order of work against the
    JAX package's f64 twin and its jnp reference, on W blocks of width P
    (seeded, on the scene's ragged observation structure) and the scene's
    damped V^-1. The same bars as at P = 3: 2e-6 of max|wz| (f32 per-track
    sums in another order; the reference's camera sums are f32 too)."""
    s = _wz_system(37, 900, drop=300)
    K = int(s["jprob"].pts_ind.shape[0])
    W = jnp.asarray(np.random.default_rng(P).normal(size=(K, P, 3)).astype(np.float32))
    Wh, c, meta = pmv.build_wh_operands(W, s["Vinv"], s["jprob"], s["M"], block_pts=128)
    x = np.random.default_rng(1).normal(size=(s["M"], P)).astype(np.float32)
    f64 = np.asarray(pmv.schur_wz_twin(jnp.asarray(x), Wh, c, meta, accum="f64"))
    ref = np.asarray(pmv.schur_wz_reference(jnp.asarray(x), Wh, c, meta))
    prob = s["tprob"]
    W_pt, W_cm = tlm.fold_layouts(t(W), t(s["Vinv"]), prob)
    args = (W_pt, prob.cam_ind_pt, W_cm, prob.pts_ind_cam)
    plain = smv.schur_wz_plain(t(x), *args).numpy()
    model, geo = schur_kernel_order(x, *(a.numpy() for a in args))
    scale = np.abs(f64).max()
    for wz in (plain, model):
        assert wz.dtype == np.float32 and wz.shape == (s["M"], P)
        assert np.abs(wz - f64).max() <= 2e-6 * scale
        assert np.abs(wz - ref).max() <= 2e-6 * scale
    assert np.abs(model - plain).max() <= 2e-6 * np.abs(plain).max()
    assert geo == smv.plan(s["M"], s["N"], P, prob.cam_ind_pt.shape[1], prob.pts_ind_cam.shape[1])


def test_operator_linear_and_zero_preserving():
    """A fixed linear operator (the CG contract); zero maps to zero, so
    sentinel slots contribute nothing."""
    s = _wz_system(37, 900)
    rng = np.random.default_rng(2)
    x1 = rng.normal(size=(s["M"], s["P"])).astype(np.float32)
    x2 = rng.normal(size=(s["M"], s["P"])).astype(np.float32)
    assert np.all(_plain(s, np.zeros_like(x1)) == 0.0)
    lin = _plain(s, x1 + 2.0 * x2)
    sep = _plain(s, x1) + 2.0 * _plain(s, x2)
    assert np.abs(lin - sep).max() <= 1e-5 * max(np.abs(sep).max(), 1e-30)


def test_wrapper_on_cpu_is_the_plain_version_and_checks_inputs():
    s = _wz_system(12, 300)
    prob = s["tprob"]
    x = torch.randn(s["M"], s["P"], dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    args = (s["W_pt"], prob.cam_ind_pt, s["W_cm"], prob.pts_ind_cam)
    before = smv.schur_wz.launches
    assert torch.equal(smv.schur_wz(x, *args), smv.schur_wz_plain(x, *args))
    assert smv.schur_wz.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="float32"):
        smv.schur_wz(x.double(), *args)
    with pytest.raises(ValueError, match="int32"):
        smv.schur_wz(x, s["W_pt"], prob.cam_ind_pt.long(), s["W_cm"], prob.pts_ind_cam)
    with pytest.raises(ValueError, match="contiguous"):
        smv.schur_wz(x.t().contiguous().t(), *args)
    with pytest.raises(ValueError, match="shapes"):
        smv.schur_wz(x[:-1].contiguous(), *args)


def test_sentinel_slots_are_masked_not_gathered():
    """Every sentinel slot (camera M, track N) must be skipped: the plain
    version gathers with clamped indices, so an unmasked sentinel would
    show up as a changed result when the clamped row changes."""
    s = _wz_system(12, 300, drop=100)
    prob = s["tprob"]
    assert bool((prob.cam_ind_pt == s["M"]).any()) and bool((prob.pts_ind_cam == s["N"]).any())
    x = np.random.default_rng(3).normal(size=(s["M"], s["P"])).astype(np.float32)
    ref = _plain(s, x)
    # scrambling W in sentinel slots changes nothing
    W_pt = s["W_pt"].clone()
    W_pt[prob.cam_ind_pt == s["M"]] = 7.0
    W_cm = s["W_cm"].clone()
    W_cm[prob.pts_ind_cam == s["N"]] = 7.0
    got = smv.schur_wz_plain(t(x), W_pt, prob.cam_ind_pt, W_cm, prob.pts_ind_cam).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", list(SCHUR_EDGE_CASES))
def test_kernel_order_model_matches_plain_on_edge_shapes(case):
    """The kernels' order of work on the shapes the card tests use (few
    cameras with long Tc, a camera with no observation, a short last chunk,
    P 1 and 9, slabs and chunks over several shared-memory pieces, one
    camera): within 2e-6 of max|wz| of the plain version, a camera without
    observations exactly 0, every slot of every camera in exactly one
    chunk."""
    args = schur_operands(*SCHUR_EDGE_CASES[case])
    M, P = args[2].shape[0], args[2].shape[2]
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(M, P)).astype(np.float32))
    ref = smv.schur_wz_plain(x, *args).numpy()
    wz, geo = schur_kernel_order(x.numpy(), *(a.numpy() for a in args))
    assert np.abs(wz - ref).max() <= 2e-6 * np.abs(ref).max()
    if SCHUR_EDGE_CASES[case][4]:
        assert np.all(wz[-1] == 0.0)
    Tc = args[3].shape[1]
    assert geo["G"] * geo["L"] >= Tc > (geo["G"] - 1) * geo["L"]


@pytest.mark.parametrize("shape,expect", [
    # slices A, B and C of chip_smoke.py (M, N, P, Tp, Tc)
    ((50, 20000, 3, 4, 1700), {"T": 64, "G": 8, "L": 213}),
    ((1000, 200000, 3, 4, 877), {"T": 64, "G": 1, "L": 877}),
    ((10, 10929, 3, 10, 10929), {"T": 32, "G": 16, "L": 684}),
    ((5000, 100, 3, 2, 40), {"T": 32, "G": 1, "L": 40}),
    ((3, 10, 3, 2, 0), {"T": 32, "G": 1, "L": 0}),
])
def test_plan_depends_on_shapes_only(shape, expect):
    """The camera tree's shape (G chunks of L slots) and the point slabs
    come from the shapes alone: G a power of two, at most 16, the chunks
    covering Tc."""
    geo = smv.plan(*shape)
    assert geo == expect
    assert geo["G"] & (geo["G"] - 1) == 0 and 1 <= geo["G"] <= smv.MAX_CHUNKS


def test_bound_operator_on_cpu_is_the_plain_version():
    s = _wz_system(12, 300, drop=40)
    prob = s["tprob"]
    args = (s["W_pt"], prob.cam_ind_pt, s["W_cm"], prob.pts_ind_cam)
    op = smv.SchurOperator(*args)
    assert op.kernels_per_call == 0
    before = smv.schur_wz.launches
    for seed in range(3):
        x = torch.randn(s["M"], s["P"], generator=torch.Generator().manual_seed(seed))
        assert torch.equal(op(x), smv.schur_wz_plain(x, *args))
        assert torch.equal(op(x), smv.schur_wz(x, *args))
    assert smv.schur_wz.launches == before  # the CPU path launches nothing


@pytest.mark.parametrize("fault,match", [
    ("W_pt_f64", "float32"), ("cam_ind_pt_i64", "int32"), ("W_cm_strided", "contiguous"),
    ("pts_ind_cam_short", "shapes"), ("W_pt_wrong_P", "shapes"), ("p12", "outside"),
    ("cam_ind_pt_flat", "shapes"),
])
def test_bound_operator_refuses_at_bind(fault, match):
    """The operand faults schur_wz refuses raise when the operator is
    bound, not at a call."""
    s = _wz_system(12, 300)
    prob = s["tprob"]
    W_pt, ci, W_cm, pi = s["W_pt"], prob.cam_ind_pt, s["W_cm"], prob.pts_ind_cam
    if fault == "W_pt_f64":
        W_pt = W_pt.double()
    elif fault == "cam_ind_pt_i64":
        ci = ci.long()
    elif fault == "W_cm_strided":
        W_cm = W_cm.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "pts_ind_cam_short":
        pi = pi[:, :-1].contiguous()
    elif fault == "W_pt_wrong_P":
        W_pt = W_pt[:, :, :2].contiguous()
    elif fault == "p12":
        W_pt = torch.zeros(W_pt.shape[:2] + (12, 3))
        W_cm = torch.zeros(W_cm.shape[:2] + (12, 3))
    else:
        ci = ci.reshape(-1)
    with pytest.raises(ValueError, match=match):
        smv.SchurOperator(W_pt, ci, W_cm, pi)


def test_coarse_inverse_drops_indefinite_operator():
    """An indefinite coarse operator yields a zero coarse term instead of
    raising (torch.linalg.cholesky would); an SPD one is inverted."""
    E_bad = torch.tensor([[1.0, 0.0, 0.0], [0.0, -2.0, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float64)
    assert torch.equal(tlm.coarse_inverse(E_bad), torch.zeros(3, 3))
    A = torch.tensor([[4.0, 1.0, 0.5], [1.0, 3.0, 0.2], [0.5, 0.2, 2.0]], dtype=torch.float64)
    Einv = tlm.coarse_inverse(A)
    assert Einv.dtype == torch.float32
    np.testing.assert_allclose(Einv.double().numpy(), torch.linalg.inv(A).numpy(), rtol=1e-5)
    # a failed dense factorization is NaN (which lm_step turns into a zero
    # step), never an exception
    dc = tlm._solve_masked_dense(-A, torch.ones(1, 3, dtype=torch.float64),
                                 torch.ones(1, dtype=torch.float64), 1, 3)
    assert torch.isnan(dc).all()
