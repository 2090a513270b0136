"""Tests of the PyTorch port that need the card: the CUDA kernels against
their plain versions. They import neither JAX nor the JAX package, and skip
where torch.cuda.is_available() is false. On a machine with an NVIDIA GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

test_distributed_solve_on_the_card starts its ranks as child processes
(this file run as a program is a rank's worker, `_dist_rank`).

`schur_kernel_order` (a numpy model of the Schur kernels' order of work)
and `schur_operands` (seeded operands with ragged tracks and cameras) live
here so that both these tests and the CPU tests of
tests/test_torch_matvec.py use them.
"""

import math

import numpy as np
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


def schur_kernel_order(x, W_pt, cam_ind_pt, W_cm, pts_ind_cam):
    """csrc/schur_matvec.cu's order of work in numpy, step for step, with
    the geometry smv.plan derives from the shapes: what[n] as one f32 sum
    per track in slot order (a product rounded, then the add: the kernel
    fuses no multiply-add); for each camera G chunks of L slots, thread t
    of 128 summing slots t, t+128, ... of its chunk in f64; a warp
    xor-butterfly, the 4 warps in order, the G chunks in order; wz rounded
    to f32. Returns wz (M, P) float32 and the geometry."""
    x, W_pt, W_cm = (np.asarray(a, np.float32) for a in (x, W_pt, W_cm))
    ci, pi = np.asarray(cam_ind_pt), np.asarray(pts_ind_cam)
    M, P = x.shape
    N, Tp = ci.shape
    Tc = pi.shape[1]
    geo = smv.plan(M, N, P, Tp, Tc)
    what = np.zeros((N, 3), np.float32)
    for t in range(Tp):
        c = ci[:, t]
        ok = (c >= 0) & (c < M)
        xc = x[np.where(ok, c, 0)]
        for p in range(P):
            for j in range(3):
                what[:, j] = np.where(ok, what[:, j] + W_pt[:, t, p, j] * xc[:, p], what[:, j])
    G, L, B = geo["G"], geo["L"], smv.CAM_THREADS
    h = what.astype(np.float64)
    r = np.arange(G)[:, None]
    acc = np.zeros((M, G, B, P))
    for k in range(-(-L // B)):
        s = r * L + np.arange(B)[None, :] + k * B  # (G, B) slot of each thread
        sc = np.minimum(s, Tc - 1)
        n = pi[:, sc]  # (M, G, B)
        ok = (s < np.minimum((r + 1) * L, Tc))[None] & (n >= 0) & (n < N)
        hn = h[np.where(ok, n, 0)]  # (M, G, B, 3)
        w = W_cm[:, sc].astype(np.float64)  # (M, G, B, P, 3)
        term = (w[..., 0] * hn[..., None, 0] + w[..., 1] * hn[..., None, 1]) \
            + w[..., 2] * hn[..., None, 2]
        acc = np.where(ok[..., None], acc + term, acc)
    v = acc.reshape(M, G, B // 32, 32, P)
    lane = np.arange(32)
    for d in (16, 8, 4, 2, 1):
        v = v + v[:, :, :, lane ^ d]
    warps = v[:, :, :, 0]  # (M, G, B // 32, P)
    chunk = warps[:, :, 0]
    for w_ in range(1, B // 32):
        chunk = chunk + warps[:, :, w_]
    total = chunk[:, 0]
    for g in range(1, G):
        total = total + chunk[:, g]
    return total.astype(np.float32), geo


def schur_operands(M, N, tp_max, P, empty_camera=False, full=False, seed=0):
    """Seeded operands in the layouts of ops/lm.fold_layouts: each track
    seen by 1..tp_max distinct cameras (every camera if full), What random,
    the two layouts padded with sentinels. empty_camera: the last camera
    has no observation. Returns CPU tensors (W_pt, cam_ind_pt, W_cm,
    pts_ind_cam)."""
    rng = np.random.default_rng(seed)
    m_used = M - 1 if empty_camera else M
    cams = [np.arange(m_used) if full else
            rng.choice(m_used, rng.integers(1, min(tp_max, m_used) + 1), replace=False)
            for _ in range(N)]
    pts_ind = np.repeat(np.arange(N), [len(c) for c in cams])
    cam_ind = np.concatenate(cams)
    K = len(cam_ind)
    wh = rng.normal(size=(K, P, 3)).astype(np.float32)
    Tp = max(len(c) for c in cams)
    Tc = int(np.bincount(cam_ind, minlength=M).max())
    cam_ind_pt = np.full((N, Tp), M, np.int32)
    W_pt = np.zeros((N, Tp, P, 3), np.float32)
    t_pt = np.arange(K) - np.repeat(np.cumsum([len(c) for c in cams]) - [len(c) for c in cams],
                                    [len(c) for c in cams])
    cam_ind_pt[pts_ind, t_pt] = cam_ind
    W_pt[pts_ind, t_pt] = wh
    order = np.argsort(cam_ind, kind="stable")
    counts = np.bincount(cam_ind, minlength=M)
    t_cm = np.arange(K) - np.repeat(np.cumsum(counts) - counts, counts)
    pts_ind_cam = np.full((M, Tc), N, np.int32)
    W_cm = np.zeros((M, Tc, P, 3), np.float32)
    pts_ind_cam[cam_ind[order], t_cm] = pts_ind[order]
    W_cm[cam_ind[order], t_cm] = wh[order]
    return tuple(torch.from_numpy(a) for a in (W_pt, cam_ind_pt, W_cm, pts_ind_cam))


def numpy_problem(p, device, solve):
    """The LMProblem of a BAParams from the numpy builders of ops/lm.py,
    each table uploaded as it is: the reference of ops/lm.problem_tables
    (the tables ba/solver.build_problem builds where the solver runs), with
    its rules for the dual layouts and the dense solves' tables (the pairs
    for DENSE_PAIRS, obs_at for DENSE_OBS_AT, none for CG)."""
    K, N, M = p.n_obs, p.n_pts, p.n_cam
    pair_k1, pair_k2 = (tlm.build_intra_track_pairs(p.pts_ind, N) if solve == tlm.DENSE_PAIRS
                        else (None, None))
    pt_table = tlm.build_gather_segments(p.pts_ind, N)
    cam_table = tlm.build_gather_segments(p.cam_ind, M)
    dual_ok = K > 0 and pt_table.size <= 4 * K and cam_table.size <= 4 * K
    obs_at = tlm.build_obs_at(p.pts_ind, p.cam_ind, N, M) if solve == tlm.DENSE_OBS_AT else None

    def idx(a, dtype=torch.int64):
        return None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def f64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)

    return tlm.LMProblem(
        pts_ind=idx(p.pts_ind), cam_ind=idx(p.cam_ind), pts2d=f64(p.pts2d),
        weights=f64(p.pts2d_w), cam_opt_mask=f64(p.cam_opt_mask),
        pts_opt_mask=f64(p.pts_opt_mask), pair_k1=idx(pair_k1), pair_k2=idx(pair_k2),
        pt_gather=idx(pt_table), cam_gather=idx(cam_table), obs_at=idx(obs_at),
        cam_ind_pt=idx(tlm.gather_table_values(pt_table, p.cam_ind, K, M), torch.int32)
        if dual_ok else None,
        pts_ind_cam=idx(tlm.gather_table_values(cam_table, p.pts_ind, K, N), torch.int32)
        if dual_ok else None)


def assert_same_problem(got, want):
    """Two LMProblems field by field: the same fields set, dtypes and
    values."""
    for name in tlm.LMProblem._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            assert torch.equal(a.cpu(), b.cpu()), name


# (M, N, tp_max, P, empty_camera, full): the card's edge shapes
SCHUR_EDGE_CASES = {
    # slice C's shape class: few cameras, every track in each, Tc long
    "c_like": (10, 3000, 10, 3, False, True),
    "empty_camera": (12, 900, 4, 3, True, False),
    # Tc = 301: two chunks of 151 slots, the last one short
    "ragged_chunk": (4, 301, 4, 3, False, True),
    "p1": (20, 1500, 5, 1, False, False),
    "p9": (30, 2000, 6, 9, False, False),
    # the matrix camera models: affine R, T, K (8); perspective R, T, K (11)
    "p8": (30, 2000, 6, 8, False, False),
    "p10": (25, 1500, 5, 10, False, False),
    "p11": (40, 2500, 6, 11, False, False),
    # P = 11 over several pieces: a 33-float row (132 bytes) puts most slab
    # and chunk starts off 16 bytes
    "p11_long_chunks": (3, 9000, 3, 11, False, True),
    # long tracks: a point CTA's slab spans several shared-memory pieces
    "long_tracks": (60, 400, 40, 9, False, True),
    # long chunks: a camera CTA's chunk spans several pieces
    "long_chunks": (2, 20000, 2, 9, False, True),
    # many cameras, one chunk each: the camera CTA writes wz itself
    "many_cameras": (1000, 3000, 4, 9, False, False),
    "one_camera": (1, 500, 1, 3, False, True),
}


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
@pytest.mark.parametrize("case", ["demo-16-2000", "demo-120-6000", *SCHUR_EDGE_CASES])
def test_schur_wz_kernel_matches_plain(cuda, case):
    """2e-6 of max|wz| against the plain version (f32 per-track sums in
    another order, f64 camera sums on both); the bits of the numpy model of
    the kernels' order of work; two calls of the function and two of the
    bound operator give the same bits (a tree fixed by the shapes, no
    atomics); one launch counted per call. The cases cover one chunk per
    camera and clusters of 2 to 16, and slabs and chunks over several
    shared-memory pieces."""
    if case.startswith("demo"):
        n_cam, n_pts = (int(v) for v in case.split("-")[1:])
        args = _operands(cuda, n_cam, n_pts)
    else:
        args = tuple(t.to(cuda) for t in schur_operands(*SCHUR_EDGE_CASES[case]))
    M, P = args[2].shape[0], args[2].shape[2]
    x = torch.randn(M, P, dtype=torch.float32, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))
    before = smv.schur_wz.launches
    wz1 = smv.schur_wz(x, *args)
    wz2 = smv.schur_wz(x, *args)
    op = smv.SchurOperator(*args)
    wz_op = op(x).clone()
    wz_op2 = op(x)
    torch.cuda.synchronize()
    assert smv.schur_wz.launches == before + 4 and op.kernels_per_call == 2
    ref = smv.schur_wz_plain(x, *args)
    assert torch.equal(wz1, wz2) and torch.equal(wz_op, wz1) and torch.equal(wz_op2, wz1)
    assert float((wz1 - ref).abs().max()) <= 2e-6 * float(ref.abs().max())
    model, geo = schur_kernel_order(*(t.cpu().numpy() for t in (x, *args)))
    assert geo == op.geometry
    np.testing.assert_array_equal(wz1.cpu().numpy(), model)


def _shifted(a, words):
    """A contiguous copy of `a` whose data starts `words` 4-byte words past
    a 16-byte boundary (a view into a larger buffer)."""
    buf = torch.empty(a.numel() + 4, dtype=a.dtype, device=a.device)
    base = (buf.data_ptr() // 4) % 4  # words past 16 bytes of element 0
    k = (words - base) % 4
    out = buf[k:k + a.numel()].view(a.shape)
    out.copy_(a)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4 * words
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("P,words", [(8, 1), (11, 1), (11, 2), (11, 3)])
def test_schur_wz_kernel_on_misaligned_operands(cuda, P, words):
    """Both What layouts and both id tables starting 4, 8 or 12 bytes past
    a 16-byte boundary, at P = 8 and 11: the staging offset puts the bulk
    copies' aligned body on 16 bytes in shared memory whatever the row
    width (33 floats at P = 11). The bits of the aligned call and of the
    numpy model; 2e-6 of max|wz| against the plain version."""
    args = tuple(t.to(cuda) for t in schur_operands(7, 3000, 5, P, full=False, seed=P))
    M = args[2].shape[0]
    x = torch.randn(M, P, dtype=torch.float32, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    aligned = smv.schur_wz(x, *args).clone()
    moved = tuple(_shifted(a, words) for a in args)
    wz = smv.schur_wz(x, *moved)
    torch.cuda.synchronize()
    assert torch.equal(wz, aligned)
    model, _ = schur_kernel_order(*(t.cpu().numpy() for t in (x, *args)))
    np.testing.assert_array_equal(wz.cpu().numpy(), model)
    ref = smv.schur_wz_plain(x, *args)
    assert float((wz - ref).abs().max()) <= 2e-6 * float(ref.abs().max())


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
@pytest.mark.parametrize("B,n1,n2,hi,dead_pair", [
    (2, 131, 45, 256, False),    # ragged N1 and N2: no multiple of 16, 8 or the 32-column tile
    (2, 70, 7, 256, False),      # N2 below one column tile
    (2, 70, 0, 256, False),      # no column at all
    (3, 301, 333, 2, True),      # binary descriptors, a pair with no valid row or column
    (1, 1500, 3000, 256, False),  # one pair: the wrapper splits its columns
])
def test_nn2_f32_tensor_core_kernel_bits_do_not_depend_on_splits(cuda, B, n1, n2, hi, dead_pair):
    """The f32 kernel (TF32 split on the tensor cores) against the plain
    version on integer descriptors, bit for bit, at ragged and edge shapes:
    through nn2_batched (the wrapper's own column split) and through the
    private launch with S = 1, 2, 3 and 7 column splits, which must all give
    the same bits."""
    d_i, d_j, li, hj, vi, vj, thr = _nn2_operands(cuda, B, n1, n2, hi=hi, empty_last=dead_pair)
    if dead_pair:
        vi[-1] = 0.0
    args = (d_i, d_j, li, hj, vi, vj, thr)
    ref = nm.nn2_plain(*args)
    before = nm.nn2_batched.launches
    f = nm.nn2_batched(*args)
    split = [nm._launch_f32(args, B, n1, n2, splits=S) for S in (1, 2, 3, 7)]
    torch.cuda.synchronize()
    assert nm.nn2_batched.launches == before + 1
    assert torch.equal(f, ref)
    for S, got in zip((1, 2, 3, 7), split):
        assert torch.equal(got, ref), S
    if dead_pair:
        assert bool((ref[-1, :2] == nm.BIG).all()) and bool((ref[-1, 2] == 0).all())
    if B == 1:
        assert nm.column_splits(B, n1, n2, cuda) > 1
    if n2:
        assert int((ref[:, 0] < nm.BIG).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,N1,N2,sms,want", [
    (45, 11000, 11000, 132, 1),   # slice C's largest chunk: the pairs fill the card
    (1, 11000, 11000, 132, 3),    # one pair: 86 row blocks, three splits
    (1, 100, 40, 132, 2),         # no more splits than column tiles
    (2, 70, 0, 132, 1),           # no columns
])
def test_column_splits_fill_the_card(cuda, B, N1, N2, sms, want):
    """The f32 kernel's column splits (nn2_match_f32_splits) aim at about two
    waves of blocks on `sms` SMs, with no more splits than column tiles."""
    assert nm._lib().nn2_match_f32_splits(B, N1, N2, sms) == want


def _fractional_operands(device):
    """_nn2_operands (3 pairs of 500 x 900) plus a uniform [0, 1) fraction
    on every descriptor value."""
    d_i, d_j, li, hj, vi, vj, thr = _nn2_operands(device, 3, 500, 900, seed=1)
    g = torch.Generator(device).manual_seed(2)
    d_i = (d_i + torch.rand(d_i.shape, generator=g, device=device)).contiguous()
    d_j = (d_j + torch.rand(d_j.shape, generator=g, device=device)).contiguous()
    return d_i, d_j, li, hj, vi, vj, thr


def _excess_over_exact_minimum(out, d_i, d_j, li, hj, vi, vj, thr):
    """Per row with a match: the exact distance (float64, from the float32
    descriptors) to the column in idx minus the exact minimum over the
    row's valid columns that pass the gate (the plain version's float32
    gate, in its order)."""
    excess = []
    for b in range(d_i.shape[0]):
        di, dj = d_i[b].double(), d_j[b].double()
        exact = (di * di).sum(1)[:, None] + (dj * dj).sum(1)[None, :] - 2.0 * (di @ dj.T)
        l, h = li[b], hj[b]
        num = (l[:, 0:1] * h[None, :, 0] + l[:, 1:2] * h[None, :, 1]) + l[:, 2:3] * h[None, :, 2]
        denom = l[:, 0:1] * l[:, 0:1] + l[:, 1:2] * l[:, 1:2]
        ok = (num * num <= (thr[b] * thr[b]) * denom) & (vi[b][:, None] > 0) & (vj[b][None, :] > 0)
        best = torch.where(ok, exact, torch.full_like(exact, math.inf)).min(1).values
        at = exact.gather(1, out[b, 2].long()[:, None])[:, 0]
        excess.append((at - best)[out[b, 0] < nm.BIG])
    return torch.cat(excess)


@pytest.mark.cuda
def test_nn2_f32_kernel_on_non_integer_descriptors(cuda):
    """The f32 kernel on descriptors with fractional parts. A distance is
    sq_i + sq_j - 2 cross, a difference of terms up to
    S = max(sq_i) + max(sq_j) (~7.0e6 here, eps * S = 0.84), and the kernel
    sums the 128 products and squares in another order than the plain
    version's cuBLAS product and reductions: distances agree to 16 ulps of S
    (measured on the TF32 tensor-core kernel: 4.5 against a tolerance of
    13.4). The argmin may move against the plain version only on rows whose
    two nearest columns lie within twice that tolerance (the descriptors
    repeat columns, so near ties are common), and on every row with a match
    the exact distance to the kernel's column lies within twice that
    tolerance of the exact minimum over the valid columns that pass the
    gate: the bar is held against exact distances, not against the plain
    version's order of sums."""
    d_i, d_j, li, hj, vi, vj, thr = _fractional_operands(cuda)
    got = nm.nn2_batched(d_i, d_j, li, hj, vi, vj, thr)
    ref = nm.nn2_plain(d_i, d_j, li, hj, vi, vj, thr)
    torch.cuda.synchronize()
    S = float((d_i * d_i).sum(-1).max() + (d_j * d_j).sum(-1).max())
    tol = 16 * torch.finfo(torch.float32).eps * S
    err = float((got[:, :2] - ref[:, :2]).abs().max())
    moved = got[:, 2] != ref[:, 2]
    excess = _excess_over_exact_minimum(got, d_i, d_j, li, hj, vi, vj, thr)
    print("non-integer descriptors: max|err| {} (16 ulp of S: {}), argmin moved in {} of {} "
          "rows; exact distance to the kernel's column over the exact minimum: max {} on {} "
          "rows".format(err, tol, int(moved.sum()), moved.numel(), float(excess.max()),
                        excess.numel()))
    assert err <= tol
    assert bool(((ref[:, 1] - ref[:, 0])[moved] <= 2 * tol).all())
    assert excess.numel() > 500 and float(excess.max()) <= 2 * tol


def _d1_error_to_exact(out, d_i, d_j):
    """d1 of a (B, 3, N1) result minus the exact distance (float64, from the
    float32 descriptors) of the row to the column in idx, over the rows with
    a match."""
    found = out[:, 0] < nm.BIG
    j = out[:, 2].long()
    d_at = torch.gather(d_j, 1, j[..., None].expand(-1, -1, d_j.shape[2]))
    exact = ((d_i.double() - d_at.double()) ** 2).sum(-1)
    return (out[:, 0].double() - exact)[found]


@pytest.mark.cuda
def test_nn2_f32_kernel_bias_against_exact_distances(cuda):
    """The TF32 split's distances against exact ones. The tensor cores
    truncate toward zero where they add, so on positive descriptors a sum
    they carry comes out low and every distance high; the kernel adds each
    k-step's sum of 8 products on the CUDA cores, round-to-nearest, so that
    only those short sums are truncated. The mean of d1's error must stay
    within 0.5 eps * S (S = max(sq_i) + max(sq_j)), every error within
    16 eps * S. Measured on these operands (744 rows with a match,
    eps * S = 0.84) with the main products in two tensor-core chains of 8
    k-steps: mean +1.27, max |err| 2.71; the plain version: mean -0.016,
    max |err| 3.04."""
    d_i, d_j, li, hj, vi, vj, thr = _fractional_operands(cuda)
    got = nm.nn2_batched(d_i, d_j, li, hj, vi, vj, thr)
    ref = nm.nn2_plain(d_i, d_j, li, hj, vi, vj, thr)
    torch.cuda.synchronize()
    S = float((d_i * d_i).sum(-1).max() + (d_j * d_j).sum(-1).max())
    eps = torch.finfo(torch.float32).eps
    e_got, e_ref = _d1_error_to_exact(got, d_i, d_j), _d1_error_to_exact(ref, d_i, d_j)
    print("d1 minus the exact distance: kernel mean {} max|err| {}; plain mean {} max|err| {}; "
          "S {} (ulp {}), {} rows".format(
              float(e_got.mean()), float(e_got.abs().max()), float(e_ref.mean()),
              float(e_ref.abs().max()), S, eps * S, e_got.numel()))
    assert e_got.numel() > 500
    assert abs(float(e_got.mean())) <= 0.5 * eps * S
    assert float(e_got.abs().max()) <= 16 * eps * S


@pytest.mark.cuda
def test_rpc_refit_on_the_card_matches_cpu(cuda):
    """fit_rpcs_batched on the card (f64 batched Cholesky) against the CPU:
    the same margins, fit errors within 1e-6 px, and the refit RPCs within
    1e-4 px of each other on a ground grid."""
    from sat_bundleadjust_tpu_torch.ba import rpcfit
    from sat_bundleadjust_tpu_torch.models.cameras import SatelliteImage
    from sat_bundleadjust_tpu_torch.models.ellipsoid import latlon_to_ecef_np
    from sat_bundleadjust_tpu_torch.models.rpc import rpc_projection_np

    rng = np.random.RandomState(0)
    off = {"col0": 0.0, "row0": 0.0, "width": 3200, "height": 1350}
    rpcs, rts = [], []
    for i in range(6):
        r = demo.make_synthetic_rpc(view_dx=300 * np.cos(i), view_dy=300 * np.sin(i))
        if i == 0:
            den = r.line_den.copy()
            den[1], den[2] = 0.05, -0.03
            r = r._replace(line_den=den, samp_den=den.copy())
        im = SatelliteImage("x.tif", r, offset=dict(off))
        im.set_camera_center()
        rpcs.append(r)
        rts.append(np.concatenate([rng.normal(0, 2e-5, 3), np.zeros(3), im.center]))
    gt = np.array([1.5, -2.0, 0.7])
    pts = np.stack(latlon_to_ecef_np(np.full(10, 11.02), np.full(10, -72.71), np.full(10, 50.0)), 1)
    args = (rts, gt, rpcs, [dict(off)] * 6, [pts + gt] * 6)
    res_cpu = rpcfit.fit_rpcs_batched(*args, device="cpu")
    stats = {}
    res_gpu = rpcfit.fit_rpcs_batched(*args, device=cuda, stats=stats)
    g = np.linspace(-1, 1, 7)
    LO, LA, AL = np.meshgrid(-72.71 + 0.03 * g, 11.02 + 0.02 * g, np.linspace(-500, 600, 5))
    for (rc, ec, mc), (rg, eg, mg) in zip(res_cpu, res_gpu):
        assert mg == mc
        assert abs(eg.max() - ec.max()) < 1e-6 and abs(np.median(eg) - np.median(ec)) < 1e-6
        pc = np.stack(rpc_projection_np(rc, LO.ravel(), LA.ravel(), AL.ravel()), 1)
        pg = np.stack(rpc_projection_np(rg, LO.ravel(), LA.ravel(), AL.ravel()), 1)
        assert np.abs(pg - pc).max() < 1e-4
    assert stats["rounds"] >= 1


@pytest.mark.cuda
def test_cv2_descriptors_through_the_int8_kernel(cuda):
    """cv2 SIFT descriptors (the opencv detector's) of two rendered 512x512
    frames, staged as the matcher stages them, through nn2_batched_i8 with
    the epipolar gate off (bruteforce) and on (epipolar_based): bit-identical
    to the plain version, one launch each; the gate only removes candidates
    (no nearest distance falls) and changes some rows' neighbours."""
    import cv2  # noqa: F401  (the opencv detector's; the card's machine has it)

    from sat_bundleadjust_tpu_torch.models.cameras import SatelliteImage
    from sat_bundleadjust_tpu_torch.ops import match as mo
    from sat_bundleadjust_tpu_torch.tracks import detection, matching
    from sat_bundleadjust_tpu_torch.utils.io import custom_equalization

    ims, rpcs = demo.render_synthetic_images(n_cam=2, h=512, w=512, seed=0, alt=0.0, device=cuda)
    feats = [detection.detect_opencv(custom_equalization((im * 255).astype(np.uint8)
                                                         .astype(np.float64))) for im in ims]
    assert min(f.shape[0] for f in feats) > 500
    staged = mo.stage_frames_for_matching(feats, device=cuda)
    assert staged is not None, "cv2 descriptors must be integers in 0..255"
    off = {"col0": 0, "row0": 0, "height": 512, "width": 512}
    F = matching.init_F_pairs_batched([(0, 1)], [SatelliteImage(im, r, offset=dict(off))
                                                 for im, r in zip(ims, rpcs)])[0]
    idx = [(np.arange(feats[0].shape[0]), np.arange(feats[1].shape[0]))]
    found = {}
    for gate, pair_F in (("off", None), ("on", F)):
        (chunk, n1, n2), = mo.staged_chunks(idx)
        ops = mo.staged_chunk_operands(staged, mo.staged_chunk_arrays(
            chunk, n1, n2, [(0, 1)], idx, [pair_F], mo.EPIPOLAR_THR))
        before = nm.nn2_batched_i8.launches
        out = nm.nn2_batched_i8(*ops)
        ref = nm.nn2_plain(*ops)
        torch.cuda.synchronize()
        assert nm.nn2_batched_i8.launches == before + 1
        assert torch.equal(out, ref), gate
        found[gate] = out[0, 0]
    assert bool((found["on"] >= found["off"]).all()) and bool((found["on"] > found["off"]).any())


def _padded_frames(seed=5):
    """Frames as the detector writes them: float64, NaN-padded to 20 000
    rows past 5 000, 6 500 and 3 800 keypoints with integer descriptors; a
    fourth frame with a NaN row among its keypoints, and a fifth that is all
    NaN."""
    rng = np.random.RandomState(seed)
    frames = []
    for k in (5000, 6500, 3800, 4200, 0):
        f = np.full((20000, 132), np.nan)
        f[:k, :2] = rng.rand(k, 2) * 2000
        f[:k, 2:4] = rng.rand(k, 2)
        f[:k, 4:] = rng.randint(0, 256, size=(k, 128))
        frames.append(f)
    frames[3][1000] = np.nan
    return frames


@pytest.mark.cuda
def test_staging_on_the_card_equals_the_cpu(cuda):
    """stage_frames_for_matching of padded frames on the card: the CPU's
    tables bit for bit (n_f 6 656, not 20 480), one read of the device a
    call, and the CPU's kernel operands from the tables, indices into the
    padding (past the table too) included."""
    import warnings

    from sat_bundleadjust_tpu_torch.ops import match as mo

    frames = _padded_frames()
    host = mo.stage_frames_for_matching(frames, device="cpu")
    counts = {}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            card = mo.stage_frames_for_matching(frames, device=cuda, counts=counts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in caught]
    assert card["n_f"] == host["n_f"] == 6656
    assert torch.equal(card["desc"].cpu(), host["desc"])
    assert torch.equal(card["hpts"].cpu(), host["hpts"])
    assert counts == {"rows_given": 5 * 20000, "rows_staged": 19500,
                      "h2d_bytes": 19500 * 132 * 8, "route": "device"}
    pair_frames = [(0, 1), (3, 2), (1, 4)]
    pair_idx = [(np.arange(0, 5000), np.r_[np.arange(0, 7000), 19999]),
                (np.arange(0, 4200), np.arange(0, 3800)),
                (np.arange(6000, 6600), np.arange(0, 100))]
    F = np.array([[0.0, 1e-4, -0.02], [-1e-4, 0.0, 0.03], [0.02, -0.03, 1.0]], np.float32)
    for chunk, n1, n2 in mo.staged_chunks(pair_idx):
        arrays = mo.staged_chunk_arrays(chunk, n1, n2, pair_frames, pair_idx, [F, None, F],
                                        mo.EPIPOLAR_THR)
        for g, h in zip(mo.staged_chunk_operands(card, arrays),
                        mo.staged_chunk_operands(host, arrays)):
            assert torch.equal(g.cpu(), h)


@pytest.mark.cuda
def test_matching_stage_span_on_the_card(cuda, tmp_path):
    """The tracks pipeline on the card, frames padded to FT_kp_max 8 000:
    its `matching.stage` span stages on the device fewer rows than the
    frames have."""
    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from sat_bundleadjust_tpu_torch.models.cameras import SatelliteImage
    from sat_bundleadjust_tpu_torch.tracks.pipeline import FeatureTracksPipeline
    from sat_bundleadjust_tpu_torch.utils import profiling

    ims, rpcs = demo.render_synthetic_images(n_cam=3, h=300, w=400, seed=0, alt=0.0, device=cuda)
    images = []
    for k, (im, rpc) in enumerate(zip(ims, rpcs)):
        path = str(tmp_path / "im{}.tif".format(k))
        Image.fromarray((im * 255).astype(np.uint8)).save(path)
        images.append(SatelliteImage(path, rpc, offset={"col0": 0, "row0": 0, "height": 300,
                                                        "width": 400}))
        images[-1].set_footprint(alt=50.0)
        images[-1].set_camera_center()
    out = str(tmp_path / "out")
    ft = FeatureTracksPipeline(out, out, {"images": images, "n_adj": 0, "aoi": None},
                               tracks_config={"FT_kp_max": 8000, "FT_save": False,
                                              "FT_reset": True}, device=cuda)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        bundle, _ = ft.build_feature_tracks()
    stage = [s[5] for s in profiling.spans() if s[2] == "matching.stage"]
    profiling.reset()
    assert bundle["C"].shape[1] > 100
    assert len(stage) == 1 and stage[0]["route"] == "device" and stage[0]["frames"] == 3
    assert 0 < stage[0]["rows_staged"] < stage[0]["rows_given"] == 3 * 8000
    assert stage[0]["h2d_bytes"] == stage[0]["rows_staged"] * 132 * 8


@pytest.mark.cuda
def test_stereo_on_the_card_matches_cpu(cuda):
    """models/stereo on the card against the CPU, rtol 1e-12 (the card's and
    the host's libm differ in the last bits of sin, cos and atan2). Heights
    and the GSD are differences of ECEF coordinates of ~6.4e6 m, so their
    rounding floor is an ulp of those (~1e-9 m; 1.9e-9 m measured on an
    H100): they are held to 1e-12 of the Earth's radius."""
    from sat_bundleadjust_tpu_torch.models import stereo

    r1 = demo.make_synthetic_rpc(view_dx=250.0, img_halfsize=(200, 150))
    r2 = demo.make_synthetic_rpc(view_dx=-180.0, view_dy=120.0, img_halfsize=(200, 150))

    def close(a, b, scale=None):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(float(np.abs(b).max()), 1e-300) if scale is None else scale
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * scale)

    earth_radius = 6.4e6

    for d in (cuda, "cpu"):
        assert stereo.gsd_from_rpc(r1, device=d) > 0
    close(stereo.geodesic_bounding_box(r1, 10, 20, 370, 260, device=cuda),
          stereo.geodesic_bounding_box(r1, 10, 20, 370, 260, device="cpu"))
    x, y, z = np.linspace(0, 400, 9), np.linspace(0, 300, 9), np.linspace(-100, 300, 9)
    got = stereo.find_corresponding_point(r1, r2, x, y, z, device=cuda)
    want = stereo.find_corresponding_point(r1, r2, x, y, z, device="cpu")
    assert got[0].device.type == cuda.type
    close(got[0].cpu(), want[0])
    close(got[1].cpu(), want[1])
    for a, b in zip(stereo.ground_control_points(r1, 0, 0, 400, 300, -50.0, 250.0, 3, device=cuda),
                    stereo.ground_control_points(r1, 0, 0, 400, 300, -50.0, 250.0, 3, device="cpu")):
        close(a, b)
    m = stereo.matches_from_rpc(r1, r2, 0, 0, 400, 300, 5, device=cuda)
    close(m, stereo.matches_from_rpc(r1, r2, 0, 0, 400, 300, 5, device="cpu"))
    h_gpu, e_gpu = stereo.compute_height(r1, r2, *m.T, device=cuda)
    h_cpu, e_cpu = stereo.compute_height(r1, r2, *m.T, device="cpu")
    close(h_gpu, h_cpu, scale=earth_radius)
    np.testing.assert_allclose(e_gpu, e_cpu, rtol=0, atol=1e-9 * 400)
    close(stereo.gsd_from_rpc(r1, z=120.0, device=cuda),
          stereo.gsd_from_rpc(r1, z=120.0, device="cpu"), scale=earth_radius)


@pytest.mark.cuda
def test_device_trace_on_the_card(cuda, tmp_path, monkeypatch):
    """utils/profiling.device_trace with SATBA_PROFILE_DIR set writes a
    Chrome trace that holds the region's CUDA kernels."""
    import glob
    import json

    from sat_bundleadjust_tpu_torch.utils.profiling import device_trace

    monkeypatch.setenv("SATBA_PROFILE_DIR", str(tmp_path))
    a = torch.randn(512, 512, device=cuda)
    with device_trace("card"):
        for _ in range(3):
            a = torch.tanh(a @ a)
    files = glob.glob(str(tmp_path / "card" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert len(kernels) >= 6, len(kernels)


@pytest.mark.cuda
def test_sift_on_the_card_gives_the_cpu_arrays(cuda):
    """The port's SIFT on a 512x512 render gives, on the card, the CPU's
    arrays bit for bit (keypoints, scales, orientations, descriptors).

    The bar is identity, not tests/test_torch_sift.py's tolerances: every
    stage is elementwise IEEE arithmetic in separate operations, which both
    devices round alike, or a reduction whose result does not depend on the
    order of its terms. The library calls that differ between the card and
    the CPU in the last bits (division by a host scalar, which the card
    turns into a product with its reciprocal; atan2, hypot, exp, sin, cos,
    pow; the histogram and descriptor sums; the norms; chip_smoke.py's
    sift_device_check measures each) are replaced by the port's own float64
    polynomials, exact integer sums and a fixed-order tree (ops/sift.py)."""
    from sat_bundleadjust_tpu_torch.ops import sift

    ims, _ = demo.render_synthetic_images(n_cam=1, h=512, w=512, seed=0, alt=0.0, device=cuda)
    f_card = sift.detect_sift(ims[0], device=cuda)
    f_cpu = sift.detect_sift(ims[0], device="cpu")
    assert f_cpu.shape[0] > 1000
    assert f_card.shape == f_cpu.shape and np.array_equal(f_card, f_cpu)


def _blur_input(B, H, W, seed):
    """Seeded float32 (B, H, W) with zeros, negatives, subnormals (~1e-39)
    and large values (~1e30, far from overflow)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W)).astype(np.float32)
    u = rng.random((B, H, W))
    x[u < 0.05] = 0.0
    x[(u >= 0.05) & (u < 0.1)] *= np.float32(1e-39)
    x[(u >= 0.1) & (u < 0.13)] *= np.float32(1e30)
    return torch.as_tensor(x)


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("taps", ["host r=5", "device r=13"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("H,W", [(1, 1), (5, 7), (16, 16), (64, 32), (67, 45), (130, 97),
                                 (200, 33)])
def test_sift_blur_kernel_gives_the_plain_bits(cuda, taps, B, H, W):
    """csrc/sift_blur.cu's blur against the plain version on the CPU, bit
    for bit: both kinds of taps (the host constants of the first blur, the
    device-computed taps of the fixed-radius blur), shapes smaller than the
    radius and not multiples of the 64 x 32 tile; one launch a call."""
    from sat_bundleadjust_tpu_torch.ops import sift

    x = _blur_input(B, H, W, seed=H * 1000 + W + B)
    if taps == "host r=5":
        k_cpu = torch.as_tensor(sift._gaussian_kernel(1.249))
        k_card = k_cpu.to(cuda)
    else:
        k_cpu = sift._dynamic_taps(torch.as_tensor(sift._sig_inc(3))[1], 13)
        k_card = sift._dynamic_taps(torch.as_tensor(sift._sig_inc(3), device=cuda)[1], 13)
        assert _same_bits(k_card, k_cpu)
    want = sift._blur_plain(x, k_cpu)
    before = sift.blur.launches
    got = sift.blur(x.to(cuda), k_card)
    torch.cuda.synchronize()
    assert sift.blur.launches == before + 1
    assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("H,W", [(1, 1), (1, 2), (2, 1), (2, 2), (5, 7), (33, 17), (64, 96)])
def test_sift_upsample_kernel_gives_the_plain_bits(cuda, B, H, W):
    """csrc/sift_blur.cu's 2x upsample against the plain version on the CPU,
    bit for bit: n = 1 (duplicated), n = 2, odd and even n."""
    from sat_bundleadjust_tpu_torch.ops import sift

    x = _blur_input(B, H, W, seed=7 * H + W + B)
    before = sift.upsample2.launches
    got = sift.upsample2(x.to(cuda))
    torch.cuda.synchronize()
    assert sift.upsample2.launches == before + 1
    assert _same_bits(got, sift._upsample_plain(x))


@pytest.mark.cuda
def test_sift_blur_kernel_writes_a_scale_space_slot(cuda):
    """Level s + 1 of a (B, S, H, W) scale space blurred from level s in
    place, as the pyramid writes it: the slot's bits, the other slots
    untouched."""
    from sat_bundleadjust_tpu_torch.ops import sift

    B, S, H, W = 3, 4, 37, 71
    ss = _blur_input(B, S, H * W, seed=3).reshape(B, S, H, W)
    k_cpu = sift._dynamic_taps(torch.as_tensor(sift._sig_inc(3))[2], 13)
    card = ss.to(cuda)
    sift.blur(card[:, 1], k_cpu.to(cuda), out=card[:, 2])
    torch.cuda.synchronize()
    want = ss.clone()
    want[:, 2] = sift._blur_plain(ss[:, 1], k_cpu)
    assert _same_bits(card, want)


@pytest.mark.cuda
def test_sift_pyramid_on_the_card_runs_the_kernels(cuda):
    """A detection on the card blurs through csrc/sift_blur.cu: the upsample
    and the first blur, then 5 blurs an octave, one launch each, as the
    `sift.pyramid` span's blur_launches counts them."""
    from torch.profiler import ProfilerActivity, profile

    from sat_bundleadjust_tpu_torch.ops import sift
    from sat_bundleadjust_tpu_torch.utils import profiling

    ims, _ = demo.render_synthetic_images(n_cam=2, h=128, w=160, seed=0, alt=0.0, device=cuda)
    profiling.reset()
    blurs, ups = sift.blur.launches, sift.upsample2.launches
    with profile(activities=[ProfilerActivity.CPU]):
        sift.detect_sift_batch(ims, device=cuda)
    octaves = len(sift._octave_slots(128, 160, 8, sift.MAX_KP_PER_OCTAVE))
    assert sift.upsample2.launches - ups == 1
    assert sift.blur.launches - blurs == 1 + 5 * octaves
    pyramid = [s for s in profiling.spans() if s[2] == "sift.pyramid"]
    assert [s[5] for s in pyramid] == [{"blur_launches": 2 + 5 * octaves}]
    profiling.reset()


@pytest.mark.cuda
def test_detect_tpu_on_the_card_is_the_batched_detection(cuda):
    """detect_tpu of one frame with a mask over its central half, on the
    card, is the batched detection of that frame (with another frame)
    restricted by the same mask: the same arrays, ordered by scale."""
    from sat_bundleadjust_tpu_torch.ops import sift
    from sat_bundleadjust_tpu_torch.tracks.detection import (_apply_mask, _top_k_by_scale,
                                                            detect_tpu)

    ims, _ = demo.render_synthetic_images(n_cam=2, h=512, w=512, seed=0, alt=0.0, device=cuda)
    mask = np.zeros((512, 512), np.uint8)
    mask[128:384, 128:384] = 1
    single = _top_k_by_scale(detect_tpu(ims[0], mask=mask, device=cuda), None)
    batched = _top_k_by_scale(_apply_mask(sift.detect_sift_batch(ims, device=cuda)[0], mask), None)
    assert single.shape[0] > 100 and np.array_equal(single, batched)


def _graph_solver(case, device):
    """A BASolver on the card: the rpc demo scene, or matrix cameras with R,
    T, K and COMMON_K (affine P = 8, perspective P = 11)."""
    if case == "rpc":
        scene = demo.make_scene_arrays(n_cam=20, n_pts=3000, seed=0, device="cpu")
        return tsolver.BASolver(demo.scene_to_baparams(scene), device=device)
    from sat_bundleadjust_tpu_torch.ba.params import BAParams

    s = demo.make_matrix_scene(case, n_cam=30, n_pts=2000, obs_per_pt=4, n_views=8,
                               noise_px=0.05, seed=0)
    p = BAParams.from_obs_table(s["pts_ind"], s["cam_ind"], s["pts2d"], s["pts0"],
                                s["cameras_init"], case, s["camera_centers"], [],
                                {"verbose": False,
                                 "correction_params": ["R", "T", "K", "COMMON_K"]})
    return tsolver.BASolver(p, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case,P", [("rpc", 3), ("affine", 8), ("perspective", 11)])
def test_captured_solve_gives_the_eager_bits(cuda, case, P):
    """BASolver's solve on the card, each LM iteration's phases as CUDA
    graphs captured at the first solve (after its first LM iteration, run
    eagerly, where the problem is the first of its kind), against the same
    phases run eagerly (graphs=False, one CG iteration a block): the same cameras, points and errors bit for bit,
    the same LM and CG iterations. A second solve replays the graphs
    without a capture and has the first's counters; schur_wz launches
    equal the operator applications under replay; at most ceil(n / k) + 1
    host reads per LM step of n CG iterations."""
    solver = _graph_solver(case, cuda)
    assert solver.mode == "cg" and solver.p.n_params == P
    ls = {"max_iter": 15}
    launches0 = smv.schur_wz.launches
    _, (cam_g, pts_g), _, err_g, captured = solver.solve(ls)
    torch.cuda.synchronize()
    launches1 = smv.schur_wz.launches
    _, (cam_r, pts_r), _, err_r, replayed = solver.solve(ls)
    torch.cuda.synchronize()
    launches2 = smv.schur_wz.launches
    _, (cam_e, pts_e), _, err_e, eager = solver.solve(ls, graphs=False)
    torch.cuda.synchronize()
    for cam, pts, err in ((cam_g, pts_g, err_g), (cam_r, pts_r, err_r)):
        assert torch.equal(cam, cam_e) and torch.equal(pts, pts_e)
        assert np.array_equal(err, err_e)
    for key in ("iterations", "cg_steps", "cg_iterations"):
        assert captured[key] == replayed[key] == eager[key], key
    for key in ("host_syncs", "cg_masked", "matvecs"):
        assert captured[key] == replayed[key], key
    assert eager["cg_masked"] == sum(n == 0 for n in eager["cg_steps"])
    assert captured["capture_s"] > 0 and replayed["capture_s"] == 0.0
    assert replayed["graph_replays"] >= captured["graph_replays"] > 0
    assert eager["graph_replays"] == 0
    assert launches1 - launches0 == captured["matvecs"] and launches2 - launches1 == (
        replayed["matvecs"])
    cg_iters = solver.config(ls).cg_iters or tlm.default_cg_iters(solver.p.n_cam)
    for info, k in ((replayed, tlm.cg_block(cg_iters, True)),
                    (eager, tlm.cg_block(cg_iters, False))):
        assert info["host_syncs"] <= sum(-(-n // k) + 1 for n in info["cg_steps"])


@pytest.mark.cuda
def test_captured_solves_of_two_problems_interleave(cuda):
    """Two problems whose graphs share the card's memory pool, solved in
    turn (each captured at its first solve, the first problem replayed after
    the second's capture, then the second again): every solve gives its
    eager solve's bits."""
    solvers = [_graph_solver("rpc", cuda), _graph_solver("affine", cuda)]
    ls = {"max_iter": 15}
    eager = [s.solve(ls, graphs=False)[1] for s in solvers]
    for n in (0, 1, 0, 1):
        _, (cam, pts), _, _, info = solvers[n].solve(ls)
        assert info["graph_replays"] > 0
        assert torch.equal(cam, eager[n][0]) and torch.equal(pts, eager[n][1]), n


@pytest.mark.cuda
def test_stage_tables_built_on_the_card(cuda):
    """rpc_ba1000's BA stage (1000 cameras, 200 000 tracks of 4
    observations, the table shuffled): the solver's tables built on the card
    equal the numpy builders', the `ba.solver.init` span says where they
    were built and what went up, and the L2 solve on them gives the bits of
    the same solve on the numpy builders' tables uploaded."""
    from torch.profiler import ProfilerActivity, profile

    from sat_bundleadjust_tpu_torch.ba.params import BAParams
    from sat_bundleadjust_tpu_torch.utils import profiling

    scene = demo.make_scene_arrays(n_cam=1000, n_pts=200_000, obs_per_pt=4, seed=0, device=cuda)
    order = np.random.RandomState(7).permutation(len(scene["pts_ind"]))
    pts0 = scene["pts3d"] + np.random.RandomState(1).randn(*scene["pts3d"].shape)
    p = BAParams.from_obs_table(scene["pts_ind"][order], scene["cam_ind"][order],
                                scene["pts2d"][order], pts0, scene["rpc_list"], "rpc",
                                list(scene["camera_centers"]), [], {"verbose": False})
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        solver = tsolver.BASolver(p, device=cuda)
    init = [s for s in profiling.spans() if s[2] == "ba.solver.init"]
    profiling.reset()
    assert len(init) == 1 and init[0][5]["tables_on"] == "cuda"
    assert init[0][5]["h2d_bytes"] == p.n_obs * (4 + 4 + 16 + 8)
    assert_same_problem(solver.prob, numpy_problem(p, cuda, tlm.CG))
    assert solver.prob.cam_ind_pt is not None and solver.prob.obs_at is None

    host = tsolver.BASolver(p, device=cuda)
    host.prob = numpy_problem(p, cuda, tlm.CG)
    (_, (cam, pts), _, err, info), (_, (cam_h, pts_h), _, err_h, info_h) = (
        s.solve(None) for s in (solver, host))
    assert torch.equal(cam, cam_h) and torch.equal(pts, pts_h) and np.array_equal(err, err_h)
    assert info["iterations"] == info_h["iterations"] > 1


@pytest.mark.cuda
def test_default_solver_on_the_card_builds_only_the_cg_tables(cuda):
    """A default BASolver on the card runs the CG (ops/lm.schur_solve) and
    builds none of the dense solves' tables, though obs_at would fit (N M =
    40 000); one that asks for the dense solve gets obs_at and no pairs."""
    p = demo.scene_to_baparams(demo.make_scene_arrays(n_cam=20, n_pts=2000, seed=0,
                                                      device="cpu"))
    solver = tsolver.BASolver(p, device=cuda)
    assert solver.mode == "cg" and solver.config().schur_mode == "cg"
    assert solver.prob.pair_k1 is None and solver.prob.pair_k2 is None
    assert solver.prob.obs_at is None and solver.prob.cam_ind_pt is not None
    dense = tsolver.BASolver(p, schur_mode="dense", device=cuda)
    assert dense.mode == "dense" and dense.prob.obs_at is not None
    assert dense.prob.pair_k1 is None


@pytest.mark.cuda
def test_outlier_pass_on_the_card_keeps_the_cpu_table(cuda):
    """The outlier pass on the observation table (ba/outliers.rm_outliers)
    on the card and on the CPU, from the same table and errors: the kept
    table bit for bit, the points within the CPU tests' 1e-4 m (the RPC
    triangulation's transcendentals differ in their last bits); the
    thresholds of every camera bit for bit at rpc_ba1000's size too."""
    from sat_bundleadjust_tpu_torch.ba import outliers

    rng = np.random.RandomState(3)
    for n_cam, n_obs in ((1000, 800_000), (7, 5000)):
        err = (np.abs(rng.randn(n_obs)) * 0.3
               + (rng.rand(n_obs) < 0.02) * rng.uniform(10, 30, n_obs)).astype(np.float32)
        cam = torch.as_tensor(rng.randint(0, n_cam, n_obs))
        thr = [outliers.camera_thresholds(torch.as_tensor(err, device=d), cam.to(d), n_cam)
               for d in (cuda, torch.device("cpu"))]
        assert torch.equal(thr[0].cpu(), thr[1])

    scene = demo.make_scene_arrays(n_cam=100, n_pts=5000, obs_per_pt=4, seed=3, device=cuda)
    p = demo.scene_to_baparams(scene)
    p.pairs_to_triangulate = [(i, (i + d) % 100) for d in (1, 2, 3) for i in range(100)]
    err = (np.abs(rng.randn(p.n_obs)) * 0.3
           + (rng.rand(p.n_obs) < 0.02) * rng.uniform(10, 30, p.n_obs)).astype(np.float32)
    card, host = (outliers.rm_outliers(err, p, device=d) for d in (cuda, "cpu"))
    for name in ("pts_ind", "cam_ind", "pts2d", "pts_prev_indices"):
        np.testing.assert_array_equal(getattr(card, name), getattr(host, name), err_msg=name)
    assert card.n_pts_fix == host.n_pts_fix and 0 < card.n_obs < p.n_obs
    np.testing.assert_allclose(card.pts3d, host.pts3d, rtol=0, atol=1e-4)


def ring_rpcs(n, curvature=0.0, seed=0, parallax=300.0):
    """n RPCs (numpy fields) of utils/demo.make_synthetic_rpc on a ring of
    views, `parallax` px per normalized altitude, view k at angle 2 pi k / n
    (parallax 0: nadir views, no term in the altitude). curvature > 0 adds
    seeded second- and third-order terms of that size to the numerators and
    first- to third-order terms to the denominators, so that the secant
    search takes 2 to 5 steps, depending on the duo."""
    from sat_bundleadjust_tpu_torch.models.rpc import RPCModel

    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        d = demo.make_synthetic_rpc(view_dx=parallax * np.cos(2 * np.pi * k / n),
                                    view_dy=parallax * np.sin(2 * np.pi * k / n))._asdict()
        for f, first in (("line_num", 4), ("samp_num", 4), ("line_den", 1), ("samp_den", 1)):
            d[f] = d[f] + curvature * rng.randn(20) * (np.arange(20) >= first)
        out.append(RPCModel(**d))
    return out


def rpc_duos(rpcs, D, seed, spread=0.8, noise=0.3):
    """D duos of the stacked table rpcs (on its device): ground points
    drawn in the normalized box [-spread, spread]^2 and -400..500 m, each
    seen by camera a and by a camera b a quarter to three quarters of the
    ring away, its pixel in b moved by `noise` px. Returns (cam_a, cam_b,
    pts_a, pts_b)."""
    from sat_bundleadjust_tpu_torch.models.rpc import index_rpc, rpc_projection

    dev = rpcs.line_num.device
    M = rpcs.line_num.shape[0]
    rng = np.random.RandomState(seed)
    ca = rng.randint(0, M, D)
    cb = (ca + rng.randint(M // 4, 3 * M // 4 + 1, D)) % M
    lon = float(rpcs.lon_offset[0]) + float(rpcs.lon_scale[0]) * rng.uniform(-spread, spread, D)
    lat = float(rpcs.lat_offset[0]) + float(rpcs.lat_scale[0]) * rng.uniform(-spread, spread, D)
    h = rng.uniform(-400.0, 500.0, D)
    shift = noise * rng.randn(D, 2)
    lon, lat, h, shift, ca, cb = (torch.as_tensor(v, device=dev)
                                  for v in (lon, lat, h, shift, ca, cb))
    pa = torch.stack(rpc_projection(index_rpc(rpcs, ca), lon, lat, h), dim=-1)
    pb = torch.stack(rpc_projection(index_rpc(rpcs, cb), lon, lat, h), dim=-1) + shift
    return ca, cb, pa, pb


def per_duo_search(rpcs, cam_a, cam_b, pts_a, pts_b):
    """csrc/rpc_triangulate.cu's schedule on the plain arithmetic
    (ops/triangulate._pair_correspondence, models/rpc.rpc_localization, the
    plain version's secant step): each duo stops on its own, once |lam| <
    RPCH_LAMBDA_STOP after that step (the converged duos leave the batch),
    then its final localization. (5, D) float64 as the kernel writes it:
    lon, lat, h, err, the secant steps taken."""
    from sat_bundleadjust_tpu_torch.models.rpc import index_rpc, rpc_localization
    from sat_bundleadjust_tpu_torch.ops import triangulate as ttri

    D = pts_a.shape[0]
    out = torch.zeros((5, D), dtype=torch.float64, device=pts_a.device)
    live = torch.arange(D, device=pts_a.device)
    for _ in range(ttri.RPCH_ITERS):
        if live.numel() == 0:
            break
        ra, rb = index_rpc(rpcs, cam_a[live]), index_rpc(rpcs, cam_b[live])
        xa, ya, xb, yb = pts_a[live, 0], pts_a[live, 1], pts_b[live, 0], pts_b[live, 1]
        h = out[2, live]
        px, py = ttri._pair_correspondence(ra, rb, xa, ya, h)
        qx, qy = ttri._pair_correspondence(ra, rb, xa, ya, h + ttri.RPCH_HSTEP)
        ax, ay = qx - px, qy - py
        bx, by = xb - px, yb - py
        a2 = ax * ax + ay * ay
        lam = (ax * bx + ay * by) / torch.where(a2 == 0, torch.ones_like(a2), a2)
        out[3, live] = torch.hypot(px + lam * ax - xb, py + lam * ay - yb)
        out[2, live] = h + lam * ttri.RPCH_HSTEP
        out[4, live] += 1
        live = live[~(lam.abs() < ttri.RPCH_LAMBDA_STOP)]
    out[0], out[1] = rpc_localization(index_rpc(rpcs, cam_a), pts_a[:, 0], pts_a[:, 1], out[2])
    return out


def _ecef(out):
    from sat_bundleadjust_tpu_torch.models import ellipsoid

    return ellipsoid.latlon_to_ecef_arr(out[1], out[0], out[2])


def _kernel_against(got, want, label):
    """The gaps between the kernel's (5, D) and a plain version's: the
    largest point distance (m), |h| and err gaps, the share of duos whose
    secant steps differ; printed (pytest -s) and returned."""
    want = want.to(got.device)
    gap = {"point_m": float((_ecef(got) - _ecef(want)).norm(dim=1).max()),
           "h_m": float((got[2] - want[2]).abs().max()),
           "err_px": float((got[3] - want[3]).abs().max()),
           "steps_differ": float((got[4] != want[4]).double().mean())}
    print("rpc_triangulate against {}: {}".format(label, gap))
    return gap


@pytest.mark.cuda
def test_rpc_triangulate_kernel_matches_plain(cuda):
    """csrc/rpc_triangulate.cu on 60 000 duos of 80 demo RPCs on one ring
    (every other one curved; the linear ones as in the robust BA cell), views
    a quarter to three quarters of the ring apart (2-5 secant steps, every
    search within the scene's altitudes), against the plain
    arithmetic with the kernel's per-duo stop on the card and on the CPU
    (per_duo_search, equal to rpc_triangulation's frozen mask: the CPU
    test test_per_duo_stop_gives_the_frozen_mask_loops_h), and the wrapper
    against rpc_triangulation on the card. Tolerances: a point within 1e-4
    m (a stop decision that flips where |lam| lies within rounding of 1e-5
    moves h by less than 1e-5 m; otherwise the gap is rounding, fmas and
    the sums' order), err within 1e-6 px, the steps equal for >= 99.9% of
    the duos. Measured on an H100 80GB HBM3: points within 3.5e-9 m, h
    within 1.3e-9 m, err within 7.7e-10 px, the steps equal for every duo."""
    from sat_bundleadjust_tpu_torch.models.rpc import index_rpc, stack_rpcs
    from sat_bundleadjust_tpu_torch.ops import triangulate as ttri

    curved, linear = ring_rpcs(80, curvature=6e-3), ring_rpcs(80)
    views = [curved[k] if k % 2 else linear[k] for k in range(80)]
    rpcs = stack_rpcs(views, cuda)
    duos = rpc_duos(rpcs, 60_000, seed=0)
    launches = ttri.rpc_triangulate.launches
    got = ttri._rpc_kernel(rpcs, *duos)
    torch.cuda.synchronize()
    assert ttri.rpc_triangulate.launches == launches + 1
    assert set(got[4].unique().tolist()) >= {2.0, 3.0, 4.0}
    host = per_duo_search(stack_rpcs(views, "cpu"), *(t.cpu() for t in duos))
    assert float(host[2].abs().max()) < 600.0  # the ground lies at -400..500 m
    for label, want in (("the plain arithmetic on the card", per_duo_search(rpcs, *duos)),
                        ("the plain arithmetic on the CPU", host)):
        gap = _kernel_against(got, want, label)
        assert gap["point_m"] <= 1e-4 and gap["h_m"] <= 1e-4, gap
        assert gap["err_px"] <= 1e-6 and gap["steps_differ"] <= 1e-3, gap
    ca, cb, pa, pb = duos
    pts3d, err = ttri.rpc_triangulate(rpcs, ca, cb, pa, pb)
    pts_p, err_p = ttri.rpc_triangulation(index_rpc(rpcs, ca), index_rpc(rpcs, cb), pa, pb)
    assert float((pts3d - pts_p).norm(dim=1).max()) <= 1e-4
    assert float((err - err_p).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_rpc_triangulate_kernel_on_degenerate_duos(cuda):
    """Duos whose search is degenerate, against the plain arithmetic on the
    CPU: the same nadir camera twice and two nadir cameras (no altitude
    term: p = q bit for bit, a2 == 0, so lam = 0: one step, h = 0); points
    three to five image half-sizes outside the image of linear RPCs, where
    the rational model is still defined; a camera index outside the table
    (the kernel's NaN row; the plain version would raise). Tolerances as in
    test_rpc_triangulate_kernel_matches_plain; measured on an H100 80GB
    HBM3: nadir views h and steps equal, err within 1.6e-13 px; outside
    the image points within 2.9e-9 m, err within 2.1e-10 px."""
    from sat_bundleadjust_tpu_torch.models.rpc import stack_rpcs
    from sat_bundleadjust_tpu_torch.ops import triangulate as ttri

    def both(rpc_list, duos):
        card = ttri._rpc_kernel(stack_rpcs(rpc_list, cuda), *(t.to(cuda) for t in duos))
        return card, per_duo_search(stack_rpcs(rpc_list, "cpu"), *duos)

    nadir = ring_rpcs(4, parallax=0.0)
    rng = np.random.RandomState(0)
    pa = torch.as_tensor(rng.uniform(0, 1000, (64, 2)))
    pb = pa + torch.as_tensor(rng.randn(64, 2))
    ca = torch.as_tensor(rng.randint(0, 4, 64))
    for cb in (ca, (ca + 1) % 4):
        card, cpu = both(nadir, (ca, cb, pa, pb))
        assert torch.equal(card[2].cpu(), torch.zeros(64, dtype=torch.float64))
        assert torch.equal(card[4].cpu(), torch.ones(64, dtype=torch.float64))
        assert torch.equal(cpu[2], card[2].cpu()) and torch.equal(cpu[4], card[4].cpu())
        gap = _kernel_against(card, cpu, "the CPU, nadir views")
        assert gap["point_m"] <= 1e-4 and gap["err_px"] <= 1e-6, gap

    linear = ring_rpcs(8)
    rpcs = stack_rpcs(linear, "cpu")
    ca, cb, pa, pb = rpc_duos(rpcs, 256, seed=1, spread=0.0, noise=0.0)
    half = torch.tensor([1600.0, 675.0], dtype=torch.float64)
    out = torch.as_tensor(rng.uniform(3, 5, (256, 2)) * rng.choice([-1, 1], (256, 2)))
    card, cpu = both(linear, (ca, cb, pa + out * half, pb + out * half))
    assert bool(torch.isfinite(card).all())
    gap = _kernel_against(card, cpu, "the CPU, points outside the image")
    assert gap["point_m"] <= 1e-4 and gap["err_px"] <= 1e-6 and gap["steps_differ"] == 0, gap

    bad = ttri._rpc_kernel(stack_rpcs(linear, cuda), torch.tensor([0, 8, -1], device=cuda),
                           torch.tensor([1, 2, 3], device=cuda),
                           torch.zeros((3, 2), dtype=torch.float64, device=cuda),
                           torch.zeros((3, 2), dtype=torch.float64, device=cuda))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(bad[:, 0]).all()) and bool(torch.isnan(bad[:, 1:]).all())


@pytest.mark.cuda
def test_triangulate_table_on_the_card_is_one_launch(cuda):
    """triangulate_table on the card: one kernel launch over all the duos,
    its `triangulate.rpc` span on the route "kernel" with no read of the
    device, the loop in one chunk, the points within 1e-4 m of the CPU's."""
    from torch.profiler import ProfilerActivity, profile

    from sat_bundleadjust_tpu_torch.ops import triangulate as ttri
    from sat_bundleadjust_tpu_torch.utils import profiling

    scene = demo.make_scene_arrays(n_cam=12, n_pts=3000, obs_per_pt=4, seed=2, device="cpu")
    pairs = [(i, j) for i in range(12) for j in range(i + 1, 12)]
    order = np.lexsort((scene["cam_ind"], scene["pts_ind"]))  # the table sorted by point
    table = [torch.as_tensor(scene[k][order]) for k in ("pts_ind", "cam_ind", "pts2d")]
    args = (3000, 12, scene["rpc_list"], "rpc", pairs)
    host, n_duos = ttri.triangulate_table(*table, *args)
    launches = ttri.rpc_triangulate.launches
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        card, n_card = ttri.triangulate_table(*(t.to(cuda) for t in table), *args)
        torch.cuda.synchronize()
    spans = profiling.spans()
    profiling.reset()
    assert ttri.rpc_triangulate.launches == launches + 1 and n_card == n_duos > 0
    assert [s[5] for s in spans if s[2] == "triangulate.rpc"] == [
        {"duos": n_duos, "route": "kernel", "host_reads": 0}]
    assert [s[5]["chunks"] for s in spans if s[2] == "triangulate.loop"] == [1]
    np.testing.assert_allclose(card.cpu().numpy(), host.numpy(), rtol=0, atol=1e-4)


def _failed_capture():
    """A child process's check: a solve whose Jacobians read the device from
    the host, which a capture refuses, raises. (An aborted capture leaves
    torch's generator and allocator in their capture state, so it runs in a
    process of its own.)"""
    solver = _graph_solver("rpc", torch.device("cuda"))
    jac_fn = solver.jac_fn

    def reading_jac_fn(cam, pts):
        out = jac_fn(cam, pts)
        float(out[0].sum())  # a host read
        return out

    solver.jac_fn = reading_jac_fn
    try:
        solver.solve({"max_iter": 5})
    except RuntimeError as e:
        print("raised {}: {}".format(type(e).__name__, str(e)[:200]))
        return
    raise SystemExit("the solve did not raise")


@pytest.mark.cuda
def test_failed_capture_raises(cuda):
    """A phase that cannot be captured makes the solve raise: no eager run
    takes its place (in a child process, _failed_capture)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    child = subprocess.run([sys.executable, __file__, "failed_capture"], capture_output=True,
                           text=True, timeout=300, cwd=repo, env=env)
    assert child.returncode == 0 and "raised" in child.stdout, child.stdout + child.stderr[-3000:]


@pytest.mark.cuda
def test_schur_operator_keeps_its_dependent_launch_in_a_graph(cuda):
    """One call of the bound operator captured into a CUDA graph: two kernel
    nodes and one edge, a programmatic one (schur_cameras stays a dependent
    launch of schur_points inside the solve's graphs)."""
    args = _operands(cuda, 16, 2000)
    op = smv.SchurOperator(*args)
    x = torch.randn(args[2].shape[0], args[2].shape[2], dtype=torch.float32, device=cuda)
    assert smv.graph_edges(op, x) == {"nodes": 2, "edges": 1, "programmatic": 1}


@pytest.mark.cuda
def test_bench_ba_mode_on_the_card(cuda, monkeypatch):
    """The port's bench (`sat_bundleadjust_tpu_torch/bench.py`) in ba mode at
    10 cameras and 2000 points on the card: the parity gate holds the
    kernel within 2e-6 of max|wz| of its plain version and 5e-5 of the aos
    form, schur_wz launches equal the matvecs of the six solves (the
    warm-up and five timed) plus the gate's own call, and the solve ends
    below 0.100 px."""
    from sat_bundleadjust_tpu_torch import bench

    monkeypatch.setenv("SATBA_BENCH_CAMS", "10")
    monkeypatch.setenv("SATBA_BENCH_PTS", "2000")
    smv.schur_wz.launches = 0
    result, rec = bench.bench_ba(cuda)
    torch.cuda.synchronize()
    assert rec["gate"]["vs_plain"] <= bench.GATE_PLAIN
    assert rec["gate"]["vs_aos"] <= bench.GATE_AOS
    matvecs = sum(s["matvecs"] for s in rec["solves"])
    assert len(rec["solves"]) == 6 and matvecs > 0
    assert smv.schur_wz.launches == matvecs + rec["gate"]["schur_wz_calls"], (
        smv.schur_wz.launches, matvecs)
    assert rec["reproj_after"] <= 0.100
    assert result["unit"].startswith("iter/s (10 cams, 2000 pts, 8000 obs, cuda ")


@pytest.mark.cuda
def test_match_pair_on_the_card_launches_nn2_single(cuda):
    """match_pair on the card with the pair's F from init_F_pair_to_match
    launches the single-pair kernel once (its counter), never the CPU
    matcher, and the kernel on the same operands is bit-identical to its
    plain version (integer descriptors); the matches lie on the F's
    epipolar lines within the gate."""
    from sat_bundleadjust_tpu_torch.ops import match as match_ops
    from sat_bundleadjust_tpu_torch.ops import sift
    from sat_bundleadjust_tpu_torch.tracks.matching import init_F_pair_to_match

    ims, rpcs = demo.render_synthetic_images(n_cam=2, h=512, w=512, seed=0, alt=0.0,
                                             device=cuda)
    fi, fj = sift.detect_sift_batch(ims, device=cuda)
    F = init_F_pair_to_match(512, 512, rpcs[0], rpcs[1])
    before = (nm.nn2_single.launches, nm.nn2_batched.launches, nm.nn2_batched_i8.launches)
    matches, n_ratio, n_ransac = match_ops.match_pair(fi, fj, F, device=cuda)
    assert (nm.nn2_single.launches, nm.nn2_batched.launches, nm.nn2_batched_i8.launches) == (
        before[0] + 1, before[1], before[2])
    assert matches is not None and n_ransac == matches.shape[0] > 50 and n_ratio >= n_ransac
    ops = match_ops.single_pair_operands(fi, fj, F, match_ops.EPIPOLAR_THR, cuda)
    d1, d2, nn = nm.nn2_single(*ops)
    ref = nm.nn2_plain(*[o[None] for o in ops[:6]],
                       torch.tensor([ops[6]], dtype=torch.float32, device=cuda))[0]
    assert torch.equal(torch.stack([d1, d2, nn.float()]), ref)
    h_i = np.hstack([fi[matches[:, 0], :2], np.ones((len(matches), 1))])
    h_j = np.hstack([fj[matches[:, 1], :2], np.ones((len(matches), 1))])
    lines = h_i @ F.T
    dist = np.abs(np.sum(lines * h_j, axis=1)) / np.hypot(lines[:, 0], lines[:, 1])
    assert dist.max() <= match_ops.EPIPOLAR_THR * (1 + 1e-5)  # the kernel's gate is f32


def _dist_rank(rank, world, port, backend, out):
    """A rank of test_distributed_solve_on_the_card: the 100-camera demo
    problem through parallel/dist_solver on the card."""
    from sat_bundleadjust_tpu_torch.parallel import multihost
    from sat_bundleadjust_tpu_torch.parallel.dist_solver import run_distributed_ba
    from sat_bundleadjust_tpu_torch.parallel.mesh import make_mesh

    multihost.initialize("127.0.0.1:" + port, int(world), int(rank), backend=backend)
    p = demo.scene_to_baparams(demo.make_scene_arrays(n_cam=100, n_pts=20000, seed=0,
                                                      device="cuda"))
    smv.schur_wz.launches = 0
    _, (cam, _), info = run_distributed_ba(p, {"max_iter": 30}, mesh=make_mesh())
    np.savez("{}{}.npz".format(out, rank), cam=cam.cpu().numpy(), err=info["err_fin"],
             counts=np.array([info["matvecs"], smv.schur_wz.launches, info["iterations"]]))
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_distributed_solve_on_the_card(cuda, tmp_path, backend, world):
    """One NCCL rank, and two gloo ranks sharing the card (NCCL takes one
    rank per device): the ranks' cameras bit-identical, schur_wz launched
    once per matvec on every rank, the final mean reprojection error within
    1e-3 px (chip_smoke.py's slice H bar) of the one-device solve's."""
    from test_torch_ranks import run_ranks

    run_ranks(__file__, [backend, str(tmp_path / "rank")], world, timeout=300)
    res = [dict(np.load(str(tmp_path / "rank{}.npz".format(r)))) for r in range(world)]
    for r in res:
        np.testing.assert_array_equal(r["cam"], res[0]["cam"])
        matvecs, launches, _ = r["counts"]
        assert launches == matvecs > 0
    p = demo.scene_to_baparams(demo.make_scene_arrays(n_cam=100, n_pts=20000, seed=0,
                                                      device=cuda))
    *_, err, _ = tsolver.run_ba_optimization(p, {"max_iter": 30}, device=cuda)
    assert abs(float(res[0]["err"].mean()) - float(err.mean())) <= 1e-3


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["failed_capture"]:
        _failed_capture()
    else:
        _dist_rank(*sys.argv[1:])
