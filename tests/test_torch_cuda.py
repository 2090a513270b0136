"""Tests of the PyTorch port that need the card: the CUDA kernels against
their plain versions. They import neither JAX nor the JAX package, and skip
where torch.cuda.is_available() is false. On a machine with an NVIDIA GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from sat_bundleadjust_tpu_torch.ba import solver as tsolver
from sat_bundleadjust_tpu_torch.ops import lm as tlm
from sat_bundleadjust_tpu_torch.ops import nn2_match as nm
from sat_bundleadjust_tpu_torch.ops import schur_matvec as smv
from sat_bundleadjust_tpu_torch.utils import demo


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _operands(device, n_cam, n_pts, lam=1e-4):
    """The CG operator's layouts at the first LM step of a demo solve."""
    scene = demo.make_scene_arrays(n_cam=n_cam, n_pts=n_pts, seed=0, device="cpu")
    p = demo.scene_to_baparams(scene)
    s = tsolver.BASolver(p, schur_mode="cg", device=device)
    cam0 = torch.as_tensor(p.opt_block(), device=device)
    pts0 = torch.as_tensor(p.pts3d, device=device)
    r, J_cam, J_pt = s.jac_fn(cam0, pts0)
    cfg = tlm.LMConfig(schur_mode="cg")
    _, _, _, _, V, W = tlm._normal_blocks(r, J_cam, J_pt, s.prob, p.n_cam, p.n_pts, cfg)
    Vinv = tlm._inv3x3(tlm._damp(V, lam)).float()
    W_pt, W_cm = tlm.fold_layouts(W.float(), Vinv, s.prob)
    return W_pt, s.prob.cam_ind_pt, W_cm, s.prob.pts_ind_cam


@pytest.mark.cuda
@pytest.mark.parametrize("n_cam,n_pts", [(16, 2000), (120, 6000)])
def test_schur_wz_kernel_matches_plain(cuda, n_cam, n_pts):
    """2e-6 of max|wz| against the plain version (f32 per-track sums in
    another order, f64 camera sums on both), and two launches give the
    same bits (no atomics)."""
    args = _operands(cuda, n_cam, n_pts)
    x = torch.randn(n_cam, 3, dtype=torch.float32, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))
    before = smv.schur_wz.launches
    wz1 = smv.schur_wz(x, *args)
    wz2 = smv.schur_wz(x, *args)
    torch.cuda.synchronize()
    assert smv.schur_wz.launches == before + 2
    ref = smv.schur_wz_plain(x, *args)
    assert torch.equal(wz1, wz2)
    assert float((wz1 - ref).abs().max()) <= 2e-6 * float(ref.abs().max())


def _nn2_operands(device, B, n1, n2, seed=0, hi=256, empty_last=True):
    """Integer descriptors 0..hi-1 (exact correspondences, tied columns; with
    hi = 2 ties are the common case), epipolar lines and points,
    invalid rows/columns, per-pair thresholds (off, 8 px, 20 px, ...) and,
    if empty_last, no valid column in the last pair."""
    g = torch.Generator().manual_seed(seed)
    d_i = torch.randint(0, hi, (B, n1, 128), generator=g).float()
    d_j = torch.randint(0, hi, (B, n2, 128), generator=g).float()
    k = min(n1, n2) // 3
    d_j[:, :k] = d_i[:, :k]
    d_j[:, k:2 * k] = d_j[:, :k]
    li = torch.cat([torch.randn(B, n1, 2, generator=g),
                    -300.0 * torch.rand(B, n1, 1, generator=g)], 2)
    hj = torch.cat([400.0 * torch.rand(B, n2, 2, generator=g), torch.ones(B, n2, 1)], 2)
    vi = (torch.rand(B, n1, generator=g) > 0.05).float()
    vj = (torch.rand(B, n2, generator=g) > 0.1).float()
    if empty_last:
        vj[-1] = 0.0
    thr = torch.tensor([1e9, 8.0, 20.0] * B)[:B]
    return [t.to(device).contiguous() for t in (d_i, d_j, li, hj, vi, vj, thr)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n1,n2,hi,empty_last", [
    (3, 300, 700, 256, True),
    (4, 1337, 2049, 256, True),
    # the int8 kernel's tile edges: 128-row blocks of two m16 tiles per
    # warp, n8 column blocks, 64-column stages
    (1, 17, 5, 256, False),     # N2 below one n8 block
    (1, 17, 65, 256, False),    # one 64-column stage + 1
    (1, 17, 65, 2, False),      # the same with ties
    (3, 300, 129, 2, True),     # gate on, ties, a pair with no valid column
    (2, 513, 1000, 2, False),   # 513 rows cross four 128-row blocks
])
def test_nn2_kernels_match_plain(cuda, B, n1, n2, hi, empty_last):
    """Each 2-NN entry point against the plain version on the same card
    tensors, at small, ragged and tile-edge sizes (N1, N2 not multiples of
    the kernels' tiles): bit-identical on integer descriptors, two launches
    give the same bits, and one launch per call is counted."""
    d_i, d_j, li, hj, vi, vj, thr = _nn2_operands(cuda, B, n1, n2, hi=hi, empty_last=empty_last)
    i8_i, i8_j = (d_i - 128).to(torch.int8), (d_j - 128).to(torch.int8)
    ref = nm.nn2_plain(i8_i, i8_j, li, hj, vi, vj, thr)
    before = (nm.nn2_batched_i8.launches, nm.nn2_batched.launches, nm.nn2_single.launches)
    a = nm.nn2_batched_i8(i8_i, i8_j, li, hj, vi, vj, thr)
    b = nm.nn2_batched_i8(i8_i, i8_j, li, hj, vi, vj, thr)
    f = nm.nn2_batched(d_i, d_j, li, hj, vi, vj, thr)
    s = nm.nn2_single(d_i[0], d_j[0], li[0], hj[0], vi[0], vj[0], float(thr[0]))
    torch.cuda.synchronize()
    assert (nm.nn2_batched_i8.launches, nm.nn2_batched.launches, nm.nn2_single.launches) == (
        before[0] + 2, before[1] + 1, before[2] + 1)
    assert torch.equal(a, ref) and torch.equal(a, b) and torch.equal(f, ref)
    assert torch.equal(torch.stack([s[0], s[1], s[2].float()]), ref[0])
    if empty_last:
        assert bool((ref[-1, 0] == nm.BIG).all()) and bool((ref[-1, 2] == 0).all())
    assert int((ref[:, 0] == ref[:, 1]).sum()) > 0


@pytest.mark.cuda
def test_nn2_f32_kernel_on_non_integer_descriptors(cuda):
    """The f32 kernel on descriptors with fractional parts. A distance is
    sq_i + sq_j - 2 cross, a difference of terms up to
    S = max(sq_i) + max(sq_j) (~1.7e7 here, float32 ulp 1-2), and the kernel
    sums the 128 products and squares in another order than the plain
    version's cuBLAS product and reductions: distances agree to 16 ulps of S
    (measured: 2.0 against S ulp 2); the argmin may differ only on rows
    whose two nearest columns lie within twice that tolerance (measured: 2
    of 1500 rows)."""
    d_i, d_j, li, hj, vi, vj, thr = _nn2_operands(cuda, 3, 500, 900, seed=1)
    g = torch.Generator(cuda).manual_seed(2)
    d_i = (d_i + torch.rand(d_i.shape, generator=g, device=cuda)).contiguous()
    d_j = (d_j + torch.rand(d_j.shape, generator=g, device=cuda)).contiguous()
    got = nm.nn2_batched(d_i, d_j, li, hj, vi, vj, thr)
    ref = nm.nn2_plain(d_i, d_j, li, hj, vi, vj, thr)
    torch.cuda.synchronize()
    S = float((d_i * d_i).sum(-1).max() + (d_j * d_j).sum(-1).max())
    tol = 16 * torch.finfo(torch.float32).eps * S
    assert float((got[:, :2] - ref[:, :2]).abs().max()) <= tol
    moved = got[:, 2] != ref[:, 2]
    assert bool(((ref[:, 1] - ref[:, 0])[moved] <= 2 * tol).all())
    assert float(moved.float().mean()) < 0.01
