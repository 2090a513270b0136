"""Tests of the PyTorch port that need the card: the CUDA kernels against
their plain versions. They import neither JAX nor the JAX package, and skip
where torch.cuda.is_available() is false. On a machine with an NVIDIA GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from sat_bundleadjust_tpu_torch.ba import solver as tsolver
from sat_bundleadjust_tpu_torch.ops import lm as tlm
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
