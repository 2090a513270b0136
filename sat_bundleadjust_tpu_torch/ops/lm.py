"""Levenberg-Marquardt with Schur-complement elimination of tie points.

Counterpart of `sat_bundleadjust_tpu/ops/lm.py`. One LM step builds the
per-camera (U), per-point (V) and per-observation (W) normal-equation
blocks, eliminates the 3x3 point blocks and solves the reduced camera
system with the solve that schur_solve chooses for the problem (whose
tables problem_tables builds):
  - DENSE_OBS_AT, DENSE_PAIRS: assemble the (P*M, P*M) reduced camera
    matrix, over the (track, camera) grid of obs_at or over the intra-track
    observation pairs, and factor it;
  - CG: matrix-free preconditioned CG on the Schur complement, whose
    operator is the schur_wz kernel (ops/schur_matvec.py), with a
    block-Jacobi preconditioner on the true Schur diagonal, an additive
    coarse level and a warm start from the previous step.

The CG runs in blocks of masked iterations (_CG.iterations): the host reads
its stop once a block. build_solve keeps each LM iteration's phases as CUDA
graphs on the card (the JAX package's while_loops as graph replays): one
launch and one host read of the device a block of CG_BLOCK iterations.
Where nothing is captured (the CPU, graphs=False, the distributed solve) a
block is one iteration. The reads,
iterations, operator applications and replays are counted in the `stats`
dict the caller passes.

Failed factorizations never raise: as in the JAX package, they produce
non-finite values that the coarse-level guard drops or the step sanitizer
turns into a rejected step.
"""

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from sat_bundleadjust_tpu_torch.ops import launches
from sat_bundleadjust_tpu_torch.ops import smallmat as sm
from sat_bundleadjust_tpu_torch.ops.robust import loss_cost, loss_scale
from sat_bundleadjust_tpu_torch.ops.schur_matvec import SchurOperator, schur_wz_plain
from sat_bundleadjust_tpu_torch.utils.profiling import span

MATVECS = ("auto", "plain", "aos")


class LMProblem(NamedTuple):
    """Static problem structure for one BA solve (tensors on the device).

    Index tensors are int64 except the two kernel layouts, which are int32."""

    pts_ind: torch.Tensor  # (K,)
    cam_ind: torch.Tensor  # (K,)
    pts2d: torch.Tensor  # (K, 2) f64
    weights: torch.Tensor  # (K,) f64
    cam_opt_mask: torch.Tensor  # (M,) f64, 1 where the camera is optimized
    pts_opt_mask: torch.Tensor  # (N,) f64
    # padded (segment, slot) -> observation tables, sentinel K: segment sums
    # as gather + dense reduce (deterministic, no atomics); None -> index_add_
    pt_gather: torch.Tensor = None  # (N, Tp)
    cam_gather: torch.Tensor = None  # (M, Tc)
    # intra-track observation pairs (DENSE_PAIRS only)
    pair_k1: torch.Tensor = None  # (Q,)
    pair_k2: torch.Tensor = None  # (Q,)
    # (N, M) observation lookup (sentinel K; DENSE_OBS_AT only)
    obs_at: torch.Tensor = None
    # dual layouts of the CG operator: camera of each track-major slot
    # (sentinel M) and track of each camera-major slot (sentinel N)
    cam_ind_pt: torch.Tensor = None  # (N, Tp) int32
    pts_ind_cam: torch.Tensor = None  # (M, Tc) int32


class LMConfig(NamedTuple):
    loss: str = "linear"
    f_scale: float = 1.0
    max_iter: int = 100
    ftol: float = 1e-4
    xtol: float = 1e-10
    lambda0: float = 1e-3
    lambda_up: float = 5.0
    lambda_down: float = 3.0
    schur_mode: str = "dense"  # "dense" | "cg"
    # CG budget per LM step; 0 = clip(n_cam // 2, 15, 60)
    cg_iters: int = 0
    # forcing term: CG stops at ||r|| <= cg_rtol * ||b||
    cg_rtol: float = 1e-1
    # additive coarse correction on the "same correction for every camera
    # of a cluster" subspace, whose modes per-camera Jacobi cannot damp
    cg_coarse: bool = True
    cg_coarse_k: int = 1  # number of contiguous camera clusters
    # CG operator: "auto" = the schur_wz kernel (its plain version on CPU
    # tensors); "plain" = schur_wz_plain; "aos" = dense f32 reductions
    matvec: str = "auto"
    # COMMON_K: the number of trailing per-camera parameters tied to one
    # value across the optimized cameras. The CG runs on P S P, P the
    # projector that averages that block over the optimized cameras (the
    # null-space method for the shared K); 0 = no tying. Only the CG solve
    # ties (schur_solve).
    tie_tail: int = 0


def default_coarse_k(n_cam):
    """Cluster count of the coarse CG level: SATBA_CG_COARSE_K where set,
    else 1 (the global cluster), as in the JAX package."""
    env = os.environ.get("SATBA_CG_COARSE_K")
    if env is not None:
        return max(1, int(env))
    return 1


def new_stats():
    """Counters a solve accumulates: host syncs (reads of the device), active
    CG iterations (and each LM step's, cg_steps), masked ones (cg_masked:
    run, their results discarded), operator applications executed
    (matvecs, masked ones included), CUDA graph replays and the seconds
    spent capturing graphs (capture_s)."""
    return {"host_syncs": 0, "cg_iterations": 0, "cg_masked": 0, "cg_steps": [], "matvecs": 0,
            "graph_replays": 0, "capture_s": 0.0}


# ----------------------------------------------------------------------
# host-side index tables (numpy; identical to the JAX package's, and the
# reference of problem_tables below)
# ----------------------------------------------------------------------


def build_intra_track_pairs(pts_ind, n_pts):
    """All ordered observation pairs (k1, k2) of the same track, track by
    track in ascending order, row-major within a track."""
    pts_ind = np.asarray(pts_ind)
    order = np.argsort(pts_ind, kind="stable")
    counts = np.bincount(pts_ind, minlength=n_pts).astype(np.int64)
    if order.size == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    sp = pts_ind[order]
    reps = counts[sp]  # each sorted observation pairs with its whole track
    k1 = np.repeat(order, reps)
    base = np.repeat(starts[sp], reps)
    within = np.arange(k1.size) - np.repeat(np.cumsum(reps) - reps, reps)
    k2 = order[base + within]
    return k1.astype(np.int32), k2.astype(np.int32)


def build_gather_segments(ind, n_segments):
    """(n_segments, T) padded table of the observations of each segment,
    T = largest segment, pad value len(ind)."""
    ind = np.asarray(ind)
    K = len(ind)
    counts = np.bincount(ind, minlength=n_segments)
    T = max(int(counts.max()) if K else 1, 1)
    order = np.argsort(ind, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    table = np.full((n_segments, T), K, dtype=np.int32)
    col = np.arange(K) - starts[ind[order]]
    table[ind[order], col] = order
    return table


def gather_table_values(table, values, n_valid, fill):
    """values[slot] for each real slot (< n_valid) of a gather table,
    `fill` for padding slots."""
    table = np.asarray(table)
    values = np.asarray(values, np.int32)
    if len(values) == 0 or n_valid <= 0:
        return np.full(table.shape, fill, np.int32)
    return np.where(
        table < n_valid, values[np.minimum(table, n_valid - 1)], np.int32(fill)
    ).astype(np.int32)


def build_obs_at(pts_ind, cam_ind, n_pts, n_cam):
    """(N, M) observation index per (track, camera), sentinel K; None when a
    track observes a camera more than once."""
    pts_ind = np.asarray(pts_ind)
    cam_ind = np.asarray(cam_ind)
    K = len(pts_ind)
    flat = pts_ind.astype(np.int64) * n_cam + cam_ind
    if len(np.unique(flat)) != K:
        return None
    table = np.full((n_pts, n_cam), K, dtype=np.int32)
    table[pts_ind, cam_ind] = np.arange(K, dtype=np.int32)
    return table


# ----------------------------------------------------------------------
# the same tables, built with torch where the observation table lives
# ----------------------------------------------------------------------

# obs_at only up to this many (track, camera) entries: the (N, M) table and
# the dense path's (N, M, P, 3) transients
OBS_AT_MAX = 30_000_000

# the Schur solves (schur_solve)
DENSE_OBS_AT, DENSE_PAIRS, CG = "dense_obs_at", "dense_pairs", "cg"


def schur_solve(device, n_cam, schur_mode=None, tie_tail=0, distributed=False, obs_at=True):
    """The Schur solve of a problem, chosen here and nowhere else:
    DENSE_OBS_AT, DENSE_PAIRS or CG.

    schur_mode: "dense" or "cg" where the caller asks for one; None is
    "dense" on the CPU up to 192 cameras, else "cg" (on CUDA, as on any
    accelerator). The CG is the only solve that ties a tail (tie_tail,
    COMMON_K) or sums over the shards of a distributed solve. A dense solve
    assembles over obs_at where that table can be built (obs_at: N M <=
    OBS_AT_MAX and no (track, camera) pair repeats), else over the
    intra-track pairs on the CPU; on the card, where that assembly scatters
    Q = sum(track length^2) blocks with atomics, the CG runs instead."""
    cpu = torch.device(device).type == "cpu"
    if schur_mode is None:
        schur_mode = "dense" if cpu and n_cam <= 192 else "cg"
    if schur_mode != "dense" or tie_tail or distributed:
        return CG
    if obs_at:
        return DENSE_OBS_AT
    return DENSE_PAIRS if cpu else CG


def _solve_of(prob, n_cam, cfg, reduce=None):
    """schur_solve's choice for a problem that problem_tables built under
    cfg's mode (obs_at is there exactly when its solve was chosen)."""
    return schur_solve(prob.pts_ind.device, n_cam, cfg.schur_mode, cfg.tie_tail,
                       reduce is not None, prob.obs_at is not None)


def _segments(ind, n_segments):
    """The stable order of ind, ind in that order, and each segment's count
    and first slot in that order."""
    ind_sorted, order = torch.sort(ind, stable=True)
    counts = torch.bincount(ind, minlength=n_segments)
    return order, ind_sorted, counts, torch.cumsum(counts, 0) - counts


def _gather_table(order, ind_sorted, starts, n_segments, width):
    """build_gather_segments' table from _segments' outputs."""
    K = order.numel()
    table = torch.full((n_segments, width), K, dtype=torch.int64, device=order.device)
    table[ind_sorted, torch.arange(K, device=order.device) - starts[ind_sorted]] = order
    return table


def problem_tables(pts_ind, cam_ind, n_pts, n_cam, schur_mode=None, tie_tail=0):
    """The index tables of an LMProblem, built by torch operations on the
    device of pts_ind and cam_ind (int64 (K,)), and the Schur solve they
    serve (schur_solve's, for schur_mode and tie_tail): pt_gather,
    cam_gather (int64); the dual layouts cam_ind_pt, pts_ind_cam (int32)
    when both padded tables hold at most 4 K slots; pair_k1, pair_k2 for
    DENSE_PAIRS and obs_at for DENSE_OBS_AT (int64); each one absent
    otherwise (the LMProblem's None). Each equals what the numpy functions
    above give on the same input. The host reads the two widths and, for
    DENSE_PAIRS, the pair count Q at once; where obs_at could serve, first
    whether a (track, camera) pair repeats."""
    dev = pts_ind.device
    K = pts_ind.numel()
    solve = schur_solve(dev, n_cam, schur_mode, tie_tail, obs_at=n_pts * n_cam <= OBS_AT_MAX)
    if solve == DENSE_OBS_AT:
        flat = torch.sort(pts_ind * n_cam + cam_ind).values
        if bool((flat[1:] == flat[:-1]).any()):
            solve = schur_solve(dev, n_cam, schur_mode, tie_tail, obs_at=False)
    order_p, sorted_p, count_p, start_p = _segments(pts_ind, n_pts)
    order_c, sorted_c, count_c, start_c = _segments(cam_ind, n_cam)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    reads = [torch.cat([count_p, zero]).max(), torch.cat([count_c, zero]).max()]
    if solve == DENSE_PAIRS:
        reads.append((count_p * count_p).sum())
    Tp, Tc, *Q = torch.stack(reads).tolist()
    Tp, Tc = max(Tp, 1), max(Tc, 1)

    tables = {"pt_gather": _gather_table(order_p, sorted_p, start_p, n_pts, Tp),
              "cam_gather": _gather_table(order_c, sorted_c, start_c, n_cam, Tc)}
    if K > 0 and n_pts * Tp <= 4 * K and n_cam * Tc <= 4 * K:
        tables["cam_ind_pt"] = torch.cat([cam_ind, zero + n_cam])[tables["pt_gather"]].int()
        tables["pts_ind_cam"] = torch.cat([pts_ind, zero + n_pts])[tables["cam_gather"]].int()
    if solve == DENSE_PAIRS:
        # each track-sorted observation pairs with its whole track, in order
        reps = count_p[sorted_p]
        r = torch.repeat_interleave(torch.arange(K, device=dev), reps, output_size=Q[0])
        shift = start_p[sorted_p] - (torch.cumsum(reps, 0) - reps)
        tables["pair_k1"] = order_p[r]
        tables["pair_k2"] = order_p[torch.arange(Q[0], device=dev) + shift[r]]
    if solve == DENSE_OBS_AT:
        obs_at = torch.full((n_pts, n_cam), K, dtype=torch.int64, device=dev)
        obs_at[pts_ind, cam_ind] = torch.arange(K, device=dev)
        tables["obs_at"] = obs_at
    return tables, solve


# ----------------------------------------------------------------------
# normal equations
# ----------------------------------------------------------------------


def _seg_sum(x, ind, n_segments, table):
    """segment_sum(x, ind): gather + dense reduce over the padded table when
    there is one (deterministic), else index_add_."""
    if table is None:
        out = torch.zeros((n_segments,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        return out.index_add_(0, ind, x)
    pad = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=0)[table].sum(dim=1)


def _seg_sum_pt(x, prob, n_pts):
    return _seg_sum(x, prob.pts_ind, n_pts, prob.pt_gather)


def _seg_sum_cam(x, prob, n_cam):
    return _seg_sum(x, prob.cam_ind, n_cam, prob.cam_gather)


def _inv3x3(V):
    """Batched closed-form 3x3 inverse (V SPD after damping)."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(det.abs() < 1e-30, torch.ones_like(det), det)
    inv = torch.stack(
        [
            torch.stack([A, B, C], dim=-1),
            torch.stack([D, E, F], dim=-1),
            torch.stack([G, H, I], dim=-1),
        ],
        dim=-2,
    )
    return inv / det[..., None, None]


def _normal_blocks(r, J_cam, J_pt, prob, n_cam, n_pts, cfg, loss=None, f_scale=None):
    """Gradient and normal-equation blocks in the Jacobian's dtype.

    r: (K, 2) f64; J_cam: (K, 2, P); J_pt: (K, 2, 3). Returns the scaled
    residual and g_cam (M, P), g_pt (N, 3), U (M, P, P), V (N, 3, 3),
    W (K, P, 3)."""
    dt = J_cam.dtype
    loss = cfg.loss if loss is None else loss
    f_scale = cfg.f_scale if f_scale is None else f_scale
    s = loss_scale(loss, r, f_scale).to(dt)  # IRLS scaling, from the f64 residual
    r = r.to(dt) * s
    J_cam = J_cam * s[..., None]
    J_pt = J_pt * s[..., None]

    J_cam = J_cam * prob.cam_opt_mask.to(dt)[prob.cam_ind][:, None, None]
    J_pt = J_pt * prob.pts_opt_mask.to(dt)[prob.pts_ind][:, None, None]

    g_cam = _seg_sum_cam(sm.mtv(J_cam, r), prob, n_cam)
    g_pt = _seg_sum_pt(sm.mtv(J_pt, r), prob, n_pts)
    U = _seg_sum_cam(sm.mtm(J_cam, J_cam), prob, n_cam)
    V = _seg_sum_pt(sm.mtm(J_pt, J_pt), prob, n_pts)
    W = sm.mtm(J_cam, J_pt)  # (K, P, 3)
    return r, g_cam, g_pt, U, V, W


def _damp(M_blocks, lam, floor=1e-12):
    """Marquardt multiplicative damping of block diagonals."""
    dt = M_blocks.dtype
    lam = torch.as_tensor(lam, device=M_blocks.device).to(dt)
    diag = torch.diagonal(M_blocks, dim1=-2, dim2=-1)
    add = lam * torch.clamp(diag, min=floor) + floor
    eye = torch.eye(M_blocks.shape[-1], dtype=dt, device=M_blocks.device)
    return M_blocks + eye * add[..., None, :]


def _schur_rhs(g_cam, g_pt, W, Vinv, prob, n_cam):
    """b = -g_cam + sum_k W_k V^-1 g_pt (reduced right-hand side)."""
    Yg = sm.mv(W, sm.mv(Vinv, g_pt)[prob.pts_ind])
    return -g_cam + _seg_sum_cam(Yg, prob, n_cam)


def _solve_masked_dense(S, b, cam_opt_mask, n_cam, P):
    """Cholesky solve of the reduced camera system with identity rows for
    frozen cameras. A failed factorization yields NaN (no exception)."""
    dt = S.dtype
    m = cam_opt_mask.to(dt).repeat_interleave(P)
    S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    b = b.reshape(-1) * m
    L, info = torch.linalg.cholesky_ex(S)
    dc = torch.cholesky_solve(b[:, None], L)[:, 0]
    dc = torch.where(info == 0, dc, torch.full_like(dc, math.nan))
    return dc.reshape(n_cam, P)


def _dense_schur_solve(U_d, W, Vinv, b, prob, n_cam, cam_opt_mask):
    """Dense reduced camera system assembled over intra-track pairs."""
    P = U_d.shape[-1]
    Y = sm.mm(W, Vinv[prob.pts_ind])  # (K, P, 3)
    contrib = sm.mbt(Y[prob.pair_k1], W[prob.pair_k2])  # (Q, P, P)
    pair_seg = prob.cam_ind[prob.pair_k1] * n_cam + prob.cam_ind[prob.pair_k2]
    S_off = torch.zeros((n_cam * n_cam, P, P), dtype=U_d.dtype, device=U_d.device)
    S_off.index_add_(0, pair_seg, contrib)
    S = -S_off.reshape(n_cam, n_cam, P, P)
    idx = torch.arange(n_cam, device=U_d.device)
    S[idx, idx] += U_d
    S = S.permute(0, 2, 1, 3).reshape(n_cam * P, n_cam * P)
    return _solve_masked_dense(S, b, cam_opt_mask, n_cam, P)


def _dense_mxu_schur_solve(U_d, W, Vinv, b, prob, n_cam, cam_opt_mask):
    """Dense reduced camera system as one (MP, 3N) x (3N, MP) product over
    the (track, camera) grid of obs_at."""
    P = U_d.shape[-1]
    dt = U_d.dtype
    Y = sm.mm(W, Vinv[prob.pts_ind])  # (K, P, 3)
    pad = torch.zeros((1, P, 3), dtype=dt, device=U_d.device)
    A = torch.cat([Y, pad])[prob.obs_at]  # (N, M, P, 3)
    B = torch.cat([W, pad])[prob.obs_at]
    n_pts = prob.obs_at.shape[0]
    Am = A.permute(1, 2, 0, 3).reshape(n_cam * P, n_pts * 3)
    Bm = B.permute(1, 2, 0, 3).reshape(n_cam * P, n_pts * 3)
    S = -torch.matmul(Am, Bm.T).reshape(n_cam, P, n_cam, P)
    idx = torch.arange(n_cam, device=U_d.device)
    S[idx, :, idx, :] += U_d
    return _solve_masked_dense(S.reshape(n_cam * P, n_cam * P), b, cam_opt_mask, n_cam, P)


# ----------------------------------------------------------------------
# matrix-free CG
# ----------------------------------------------------------------------


def fold_layouts(W, Vinv, prob):
    """What = W chol(V^-1) in the track-major (N, Tp, P, 3) and camera-major
    (M, Tc, P, 3) layouts, zero in empty slots. Full f32 products."""
    P = W.shape[1]
    Lc = sm.chol3x3(0.5 * (Vinv + Vinv.transpose(-1, -2)))
    W_pad = torch.cat([W, torch.zeros((1, P, 3), dtype=W.dtype, device=W.device)])
    W_pt = sm.mm(W_pad[prob.pt_gather], Lc[:, None])
    Lc_pad = torch.cat([Lc, torch.zeros((1, 3, 3), dtype=Lc.dtype, device=Lc.device)])
    W_cm = sm.mm(W_pad[prob.cam_gather], Lc_pad[prob.pts_ind_cam.long()])
    return W_pt, W_cm


def schur_wz_aos(x, W_pt, cam_ind_pt, W_cm, pts_ind_cam):
    """The operator of ops/schur_matvec.py as two dense f32 reductions over
    the padded layouts (the JAX package's "aos" matvec): no wide sum on
    the camera side."""
    M, N = x.shape[0], W_pt.shape[0]
    ci = cam_ind_pt.long()
    xg = x[ci.clamp(max=M - 1)] * (ci < M).to(x.dtype)[..., None]
    what = torch.sum(sm.mtv(W_pt, xg), dim=1)
    return torch.sum(sm.mv(W_cm, what[pts_ind_cam.long().clamp(max=N - 1)]), dim=1)


def tied_tail_projector(m, P, tie_tail):
    """x (M, P) -> x with its trailing tie_tail columns replaced, on the
    optimized cameras (m = 1), by their mean over those cameras; frozen
    cameras keep theirs. The identity when tie_tail is 0. Device ops only
    (no host sync), so that a bound CG step stays capture-safe."""
    if not tie_tail:
        return lambda x: x
    t = tie_tail
    msum = torch.clamp(torch.sum(m), min=1.0)

    def proj(x):
        tail = x[:, P - t:]
        shared = torch.sum(tail * m, dim=0) / msum
        return torch.cat([x[:, :P - t], shared[None, :] * m + tail * (1.0 - m)], dim=1)

    return proj


# CG iterations a block where the block is a CUDA graph: the host reads the
# CG's stop once a block
CG_BLOCK = 8


def cg_block(cg_iters, captured):
    """Iterations per CG block: CG_BLOCK, or cg_iters when that is smaller,
    where the block is a captured CUDA graph (a read there drains the card
    after each replay); 1 where nothing is captured (the CPU, graphs=False,
    the distributed solve), since a read there saves nothing and a masked
    iteration costs its launches."""
    return max(1, min(CG_BLOCK, int(cg_iters))) if captured else 1


class _CG:
    """One matrix-free preconditioned CG solve on the Schur complement, in
    float32: its operator, preconditioner and state x, r, p, rz and the
    int32 count of iterations `it`, device tensors that `iterations`
    advances in place.

    matvec(x) = U x - W V^-1 W^T x. LM only needs a descent direction, so
    the budget is truncated (cg_iters) with forcing term cg_rtol. With
    tie_tail the projector of tied_tail_projector is applied to b, to every
    operator result and to every preconditioner application.

    reduce: the sum over the shards of a distributed solve (an all-reduce,
    parallel/dist_solver.py), where the JAX package takes its psum: each
    shard applies its own U_d and wz and the operator result is summed, and
    so are the block-Jacobi diagonal and the coarse E. b arrives summed.
    Every value the loop tests is then the same on every rank.

    Nothing here reads the device from the host: the set-up and the
    iterations can be captured in a CUDA graph (build_solve)."""

    def __init__(self, U_d, W, Vinv, b, prob, n_cam, cam_opt_mask, cg_iters, cg_rtol=1e-2,
                 tie_tail=0, x0=None, coarse=True, coarse_k=1, matvec_impl="auto", stats=None,
                 reduce=None):
        if matvec_impl not in MATVECS:
            raise ValueError("matvec must be one of {}, got {!r}".format(MATVECS, matvec_impl))
        stats = new_stats() if stats is None else stats
        self.out_dtype = b.dtype
        self.cg_iters = int(cg_iters)
        f32 = torch.float32
        scale = torch.clamp(b.abs().max(), min=1e-30)
        U_d = (U_d / scale).to(f32)
        W = (W / torch.sqrt(scale)).to(f32)
        Vinv = Vinv.to(f32)
        b = (b / scale).to(f32)
        P = U_d.shape[-1]
        n_pts = Vinv.shape[0]
        dev = U_d.device
        m = cam_opt_mask.to(f32)[:, None]

        dual_layout = prob.cam_ind_pt is not None and prob.pts_ind_cam is not None
        if dual_layout:
            W_pt, W_cm = fold_layouts(W, Vinv, prob)
            if matvec_impl == "auto":
                # bound once per LM step: the CG's calls launch the kernels only
                op = SchurOperator(W_pt, prob.cam_ind_pt, W_cm, prob.pts_ind_cam)

                def wz_of(x):
                    return op(x.contiguous())
            else:
                op = {"aos": schur_wz_aos, "plain": schur_wz_plain}[matvec_impl]

                def wz_of(x):
                    return op(x.contiguous(), W_pt, prob.cam_ind_pt, W_cm, prob.pts_ind_cam)
        else:
            pts_ind, cam_ind = prob.pts_ind, prob.cam_ind

            def wz_of(x):
                wtx = _seg_sum_pt(sm.mtv(W, x[cam_ind]), prob, n_pts)
                return _seg_sum_cam(sm.mv(W, sm.mv(Vinv, wtx)[pts_ind]), prob, n_cam)

        def matvec(x):
            stats["matvecs"] += 1
            out = sm.mv(U_d, x) - wz_of(x)
            if reduce is not None:
                out = reduce(out)
            return out * m + x * (1.0 - m)

        # block-Jacobi preconditioner on the true Schur diagonal
        # S_cc = U_cc - sum_{k in obs(c)} Y_k W_k^T
        if dual_layout:
            S_diag = U_d - torch.sum(sm.mbt(W_cm, W_cm), dim=1)
        else:
            Y = sm.mm(W, Vinv[prob.pts_ind])
            S_diag = U_d - _seg_sum_cam(sm.mbt(Y, W), prob, n_cam)
        if reduce is not None:
            S_diag = reduce(S_diag)
        eye_p = torch.eye(P, dtype=f32, device=dev)
        prec, info = torch.linalg.inv_ex(S_diag + eye_p * 1e-12)
        prec = torch.where((info == 0)[:, None, None], prec, torch.full_like(prec, math.nan))

        if coarse:
            G = max(1, int(coarse_k))
            E, Zg = coarse_schur_E(U_d, W, Vinv, prob, m, n_pts,
                                   W_pt=W_pt if dual_layout else None,
                                   n_clusters=G)
            if reduce is not None:
                E = reduce(E)
            Einv = coarse_inverse(E.reshape(G * P, G * P))

        proj = tied_tail_projector(m, P, tie_tail)

        def apply_prec(v):
            pv = proj(v)
            out = sm.mv(prec, pv)
            if coarse:
                vc = (Zg.T @ pv).reshape(-1)
                out = out + Zg @ (Einv @ vc).reshape(G, P)
            return proj(out * m + v * (1.0 - m))

        b = proj(b * m)
        rr0 = torch.sum(b * b)
        if x0 is None:
            x = torch.zeros_like(b)
            r = b
        else:
            # warm start from the previous LM step, unless it is a worse start
            # than zero
            x0 = proj(x0.to(f32) * m)
            r_w = b - proj(matvec(x0))
            use_warm = torch.sum(r_w * r_w) < rr0
            x = torch.where(use_warm, x0, torch.zeros_like(b))
            r = torch.where(use_warm, r_w, b)
        z = apply_prec(r)
        self.matvec, self.apply_prec, self.proj = matvec, apply_prec, proj
        self.tol = (cg_rtol * cg_rtol) * rr0
        self.one = torch.ones((), dtype=f32, device=dev)
        # the state, in tensors of its own (the iterations write them in place)
        self.x, self.r, self.p = x.clone(), r.clone(), z.clone()
        self.rz = torch.sum(r * z)
        self.it = torch.zeros((), dtype=torch.int32, device=dev)
        # what the host reads: (it, active)
        self.status = torch.stack([self.it, self._active(self.r, self.it)])

    def _active(self, r, it):
        """JAX's loop condition, as an int32 0 or 1."""
        return ((torch.sum(r * r) > self.tol) & (it < self.cg_iters)).to(torch.int32)

    def iterations(self, k):
        """k CG iterations, each committed only where it is active (the
        residual above the forcing term and fewer than cg_iters done): a
        masked iteration leaves the state bit for bit as it was, through
        torch.where, so that a NaN or inf of its arithmetic never leaks.
        Then the status (it, active) for the host."""
        x, r, p, rz, it = self.x, self.r, self.p, self.rz, self.it
        one = self.one
        for _ in range(k):
            active = self._active(r, it) > 0
            Ap = self.proj(self.matvec(p))
            denom = torch.sum(p * Ap)
            alpha = rz / torch.where(denom.abs() < 1e-30, one, denom)
            x_new = x + alpha * p
            r_new = r - alpha * Ap
            z = self.apply_prec(r_new)
            rz_new = torch.sum(r_new * z)
            beta = rz_new / torch.where(rz.abs() < 1e-30, one, rz)
            p_new = z + beta * p
            x = torch.where(active, x_new, x)
            r = torch.where(active, r_new, r)
            p = torch.where(active, p_new, p)
            rz = torch.where(active, rz_new, rz)
            it = it + active.to(torch.int32)
        for dst, src in ((self.x, x), (self.r, r), (self.p, p), (self.rz, rz), (self.it, it)):
            dst.copy_(src)
        self.status.copy_(torch.stack([it, self._active(r, it)]))

    def solution(self):
        return self.x.to(self.out_dtype)


def run_cg(block, status, k, stats, read_first=False):
    """Runs block(), k masked CG iterations, until the host reads the CG's
    stop from status (it, active): after each block, and before the first
    one too when read_first. Counts the reads, the active iterations and the
    masked ones into stats; returns the active iterations."""
    ran, active = 0, True
    if read_first:
        stats["host_syncs"] += 1
        with span("lm.cg_read"):
            it, active = status.tolist()
    while active:
        block()
        ran += k
        stats["host_syncs"] += 1
        with span("lm.cg_read"):
            it, active = status.tolist()
    stats["cg_iterations"] += it
    stats["cg_masked"] += ran - it
    stats["cg_steps"].append(it)
    return it


def coarse_inverse(E):
    """f32 inverse of the coarse operator E (GP, GP) through a
    ridge-regularized Cholesky, or zeros when E is not SPD (f32 cancellation
    at late-LM damping): an indefinite additive preconditioner term would
    make CG diverge, so the coarse level is dropped for that step. Never
    raises and never synchronizes (cholesky_ex, not cholesky)."""
    f32 = torch.float32
    GP = E.shape[0]
    E = E.to(f32)
    ridge = torch.trace(E) / GP * 1e-6 + 1e-30
    eye = torch.eye(GP, dtype=f32, device=E.device)
    L, info = torch.linalg.cholesky_ex(E + ridge * eye)
    Einv = torch.cholesky_solve(eye, L)
    ok = (info == 0) & torch.all(torch.isfinite(Einv))
    return torch.where(ok, Einv, torch.zeros_like(Einv))


def coarse_schur_E(U_d, W, Vinv, prob, m, n_pts, W_pt=None, n_clusters=1):
    """Galerkin coarse operator E = Z^T S Z of the two-level preconditioner,
    Z = Zg (x) I_P with Zg the (M, G) indicator of G contiguous camera
    clusters masked by m. Returns (E, Zg); G = 1 gives a (P, P) E.

    W_pt: the folded track-major layout (E_bot = Whsum Whsum^T); otherwise
    the per-observation W with a segment sum over tracks."""
    P = U_d.shape[-1]
    M = U_d.shape[0]
    G = max(1, int(n_clusters))
    dev = U_d.device
    m = m.reshape(-1, 1)
    groups = torch.clamp(torch.arange(M, device=dev) * G // M, max=G - 1)
    Zg = (groups[:, None] == torch.arange(G, device=dev)[None, :]).to(U_d.dtype) * m
    if W_pt is not None:
        Zg_pad = torch.cat([Zg, torch.zeros((1, G), dtype=Zg.dtype, device=dev)])
        slot_g = Zg_pad[prob.cam_ind_pt.long()]  # (N, Tp, G)
        Wsum = torch.einsum("ntpj,ntg->ngpj", W_pt, slot_g)
        E_bot = torch.einsum("ngpi,nhqi->gphq", Wsum, Wsum)
    else:
        zk = Zg[prob.cam_ind]  # (K, G)
        Wz = W[:, None] * zk[..., None, None]
        Wsum = torch.zeros((n_pts,) + tuple(Wz.shape[1:]), dtype=W.dtype, device=dev)
        Wsum.index_add_(0, prob.pts_ind, Wz)
        E_bot = torch.einsum("ngpi,nij,nhqj->gphq", Wsum, Vinv, Wsum)
    E_top = torch.einsum("mg,mpq,mh->gphq", Zg, U_d, Zg)
    E = E_top - E_bot
    if G == 1:
        E = E.reshape(P, P)
    return E, Zg


# ----------------------------------------------------------------------
# LM step and driver
# ----------------------------------------------------------------------


def default_cg_iters(n_cam):
    return max(15, min(60, n_cam // 2))


def _schur_system(r, J_cam, J_pt, lam, prob, n_cam, n_pts, cfg, loss=None, f_scale=None,
                  reduce=None):
    """The damped normal equations of one LM step with the points
    eliminated: (U_d, W, Vinv, b, g_pt), b the reduced right-hand side."""
    r, g_cam, g_pt, U, V, W = _normal_blocks(
        r, J_cam, J_pt, prob, n_cam, n_pts, cfg, loss=loss, f_scale=f_scale
    )
    if reduce is not None:
        g_cam = reduce(g_cam)
    dt = U.dtype
    U_d = _damp(U, lam)
    V_d = _damp(V, lam)
    # frozen points: V = I so that dp = -V^-1 g_pt = 0 (g_pt is masked)
    eye = torch.eye(3, dtype=dt, device=U.device)
    pmask = prob.pts_opt_mask.to(dt)
    V_d = V_d * pmask[:, None, None] + eye * (1.0 - pmask)[:, None, None]
    Vinv = _inv3x3(V_d)

    b = _schur_rhs(g_cam, g_pt, W, Vinv, prob, n_cam)
    if reduce is not None:
        # the W V^-1 g_pt part of b is the shard's own; -g_cam was summed
        # already, so it is added back before the sum and taken off after
        b = reduce(b + g_cam) - g_cam
    return U_d, W, Vinv, b, g_pt


def _dense_solve(system, prob, n_cam, solve):
    U_d, W, Vinv, b, _ = system
    assemble = _dense_mxu_schur_solve if solve == DENSE_OBS_AT else _dense_schur_solve
    return assemble(U_d, W, Vinv, b, prob, n_cam, prob.cam_opt_mask.to(U_d.dtype))


def _cg_of(system, prob, n_cam, cfg, x0_cam, stats, reduce=None):
    U_d, W, Vinv, b, _ = system
    return _CG(U_d, W, Vinv, b, prob, n_cam, prob.cam_opt_mask.to(U_d.dtype),
               cfg.cg_iters or default_cg_iters(n_cam), cg_rtol=cfg.cg_rtol,
               tie_tail=cfg.tie_tail, x0=x0_cam, coarse=cfg.cg_coarse,
               coarse_k=cfg.cg_coarse_k, matvec_impl=cfg.matvec, stats=stats, reduce=reduce)


def _back_substitute(dcam, system, prob, n_pts, reduce=None):
    """(dcam, dpt) of a camera step: dp = -V^-1 (g_pt + W^T dcam), both
    masked, and both zero where either is not finite."""
    _, W, Vinv, _, g_pt = system
    dt = W.dtype
    wtdc = _seg_sum_pt(sm.mtv(W, dcam[prob.cam_ind]), prob, n_pts)
    dpt = -sm.mv(Vinv, g_pt + wtdc) * prob.pts_opt_mask.to(dt)[:, None]
    dcam = dcam * prob.cam_opt_mask.to(dt)[:, None]
    # a non-finite step (failed factorization, indefinite CG) becomes a zero
    # step, which the driver treats as a rejected iteration
    finite = torch.isfinite(dcam.sum()) & torch.isfinite(dpt.sum())
    if reduce is not None:
        # dpt is the shard's own: every rank takes the step only if every
        # shard's is finite, so that the ranks' cameras stay the same
        finite = reduce((~finite).to(dt).reshape(1))[0] == 0
    dcam = torch.where(finite, dcam, torch.zeros_like(dcam))
    dpt = torch.where(finite, dpt, torch.zeros_like(dpt))
    return dcam, dpt


def lm_step(r, J_cam, J_pt, lam, prob, n_cam, n_pts, cfg, loss=None, f_scale=None,
            x0_cam=None, stats=None, reduce=None):
    """One damped Schur-complement solve. Returns (dcam (M, P), dpt (N, 3)).

    x0_cam: CG warm start (the previous step's dcam); ignored by a dense
    solve (_solve_of).
    reduce: the sum over the shards of a distributed solve (see _CG), taken
    where the JAX package takes its psum: g_cam, the right-hand side and,
    inside the CG, the operator results, the block-Jacobi diagonal and the
    coarse E. The normal blocks stay local and are damped per shard; a
    reduced solve is always the CG. The CG runs one iteration at a time, its
    stop read before each one (a masked iteration would cost collectives)."""
    stats = new_stats() if stats is None else stats
    system = _schur_system(r, J_cam, J_pt, lam, prob, n_cam, n_pts, cfg, loss=loss,
                           f_scale=f_scale, reduce=reduce)
    solve = _solve_of(prob, n_cam, cfg, reduce)
    if solve != CG:
        dcam = _dense_solve(system, prob, n_cam, solve)
    else:
        cg = _cg_of(system, prob, n_cam, cfg, x0_cam, stats, reduce=reduce)
        run_cg(lambda: cg.iterations(1), cg.status, 1, stats, read_first=True)
        dcam = cg.solution()
    return _back_substitute(dcam, system, prob, n_pts, reduce=reduce)


_CAPTURE = {}
# the kinds of problem (_Iteration.kind) whose phases have run on their
# card's capture stream
_WARMED = set()


def _capture_context(dev):
    """(stream, pool) of a card: the side stream on which its LM phases are
    warmed up and captured, and the memory pool all its captures share.

    One of each a card: the libraries' per-stream handles and workspaces
    come into being once, and a problem's graphs take the memory that the
    graphs of problems freed before it held, where a pool of their own
    would cudaMalloc it anew (each new segment costs milliseconds). The
    pool is that of an anchor graph of one small fill, kept for the
    process, so that it outlives every solver's graphs (and keeps the most
    memory the graphs alive at once have needed). The sharing is safe
    because solves run one at a time: a problem keeps values in the pool
    only from one phase to the next within its solve, and each solve's
    first phase writes them anew."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _CAPTURE:
        stream, anchor = torch.cuda.Stream(key), torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            anchor.capture_begin()
            try:
                torch.zeros(1, device=torch.device("cuda", key))
            finally:
                anchor.capture_end()
        _CAPTURE[key] = (stream, anchor)
    stream, anchor = _CAPTURE[key]
    return stream, anchor.pool()


class _Graph:
    """A CUDA graph of one phase. Capturing runs nothing: the operator
    applications and kernel launches (ops/launches.py) the phase makes
    while it is captured are taken off the counters again, and every replay
    adds them. The capture calls the graph's own begin and end on the
    capture stream: torch.cuda.graph's context would also synchronize and
    empty the allocator's cache at each of a problem's three captures."""

    def __init__(self, fn, pool, stream, stats):
        matvecs, before = stats["matvecs"], launches.snapshot()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(stream):
                self.graph.capture_begin(pool=pool)
                try:
                    fn()
                finally:
                    self.graph.capture_end()
        finally:
            self.matvecs = stats["matvecs"] - matvecs
            self.launches = launches.take(before)
            stats["matvecs"] = matvecs

    def replay(self, stats):
        self.graph.replay()
        stats["matvecs"] += self.matvecs
        launches.add(self.launches)
        stats["graph_replays"] += 1


class _Iteration:
    """One LM iteration of one problem under one loss, as phases on state
    tensors of its own that the phases update in place (cam, pts, lam, cost,
    done, dcam_prev; the host fills them only at the start of a solve):

      pre:   the Jacobians, the damped Schur system and the CG's set-up
             (fold, operator binding, preconditioner, coarse level, warm
             start), or the dense solve;
      block: k masked CG iterations and their status (it, active);
      post:  the back-substitution, the trial cost and the accept / reject.

    With `captures` (CUDA tensors, graphs wanted) each phase becomes a CUDA
    graph (_capture_context) at the problem's first LM iteration under this
    loss, and every iteration of every solve replays them. The first
    problem of its kind on the card runs that iteration eagerly on the
    capture stream instead, as the capture's warm-up, and captures before
    its second."""

    def __init__(self, residual_fn, jac_fn, n_cam, n_pts, prob, cfg, loss, f_scale, cam, pts,
                 captures):
        self.residual_fn, self.jac_fn = residual_fn, jac_fn
        self.n_cam, self.n_pts, self.prob, self.cfg = n_cam, n_pts, prob, cfg
        self.loss, self.f_scale = loss, f_scale
        self.solve = _solve_of(prob, n_cam, cfg)
        self.dense = self.solve != CG
        self.captures = captures
        self.k = cg_block(cfg.cg_iters, captures)
        dev, dt = cam.device, cam.dtype
        # what decides the ops the phases run, beside the shapes
        self.kind = (str(dev), cam.shape[1], cfg.tie_tail, self.dense, cfg.cg_coarse, cfg.matvec)
        self.cam, self.pts = torch.empty_like(cam), torch.empty_like(pts)
        self.dcam_prev = torch.empty_like(cam)
        self.lam, self.cost, self.cost_floor = (torch.empty((), dtype=dt, device=dev)
                                                for _ in range(3))
        self.done = torch.empty((), dtype=torch.bool, device=dev)
        self.graphs = None
        self.stats = new_stats()

    def fill(self, cam, pts, cost, cost_floor):
        self.cam.copy_(cam)
        self.pts.copy_(pts)
        self.lam.fill_(self.cfg.lambda0)
        self.cost.copy_(cost)
        self.cost_floor.copy_(cost_floor)
        self.done.fill_(False)
        self.dcam_prev.zero_()

    def pre(self):
        r, J_cam, J_pt = self.jac_fn(self.cam, self.pts)
        self.system = _schur_system(r, J_cam, J_pt, self.lam, self.prob, self.n_cam, self.n_pts,
                                    self.cfg, loss=self.loss, f_scale=self.f_scale)
        if self.dense:
            self.dcam = _dense_solve(self.system, self.prob, self.n_cam, self.solve)
        else:
            self.cg = _cg_of(self.system, self.prob, self.n_cam, self.cfg, self.dcam_prev,
                             self.stats)

    def block(self):
        self.cg.iterations(self.k)

    def post(self):
        cfg = self.cfg
        dcam = self.dcam if self.dense else self.cg.solution()
        dcam, dpt = _back_substitute(dcam, self.system, self.prob, self.n_pts)
        cam, pts, lam, cost = self.cam, self.pts, self.lam, self.cost
        cam_new = cam + dcam
        pts_new = pts + dpt
        new_cost = loss_cost(self.loss, self.residual_fn(cam_new, pts_new), self.f_scale)
        improved = new_cost < cost
        rel_drop = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        # scipy-TRF-style step-size criterion (xtol)
        step_norm = torch.sqrt(torch.sum(dcam * dcam) + torch.sum(dpt * dpt))
        x_norm = torch.sqrt(torch.sum(cam * cam) + torch.sum(pts * pts))
        small_step = step_norm < cfg.xtol * (x_norm + cfg.xtol)
        lam_new = torch.where(improved, lam / cfg.lambda_down, lam * cfg.lambda_up)
        cost_new = torch.where(improved, new_cost, cost)
        done = (
            self.done
            | (improved & (rel_drop < cfg.ftol))
            | (improved & small_step)
            | (lam_new > 1e12)
            | (cost_new <= self.cost_floor)
        )
        self.cam.copy_(torch.where(improved, cam_new, cam))
        self.pts.copy_(torch.where(improved, pts_new, pts))
        self.lam.copy_(lam_new)
        self.cost.copy_(cost_new)
        self.done.copy_(done)
        # the step warm-starts the next CG, even when rejected
        self.dcam_prev.copy_(dcam.to(cam.dtype))

    def phases(self):
        return ("pre", "post") if self.dense else ("pre", "block", "post")

    def capture(self, stats):
        """Each phase as a CUDA graph, on the card's capture stream (which
        ran the first iteration) and memory pool."""
        stream, pool = _capture_context(self.cam.device)
        self.stats = stats
        self.graphs = {name: _Graph(getattr(self, name), pool, stream, stats)
                       for name in self.phases()}

    def phase(self, name, stats):
        if self.graphs is not None:
            self.graphs[name].replay(stats)
        else:
            self.stats = stats
            getattr(self, name)()

    def one(self, stats):
        """One LM iteration: its phases, the CG blocks until their stop."""
        self.phase("pre", stats)
        if not self.dense:
            run_cg(lambda: self.phase("block", stats), self.cg.status, self.k, stats)
        self.phase("post", stats)

    def warm_up(self, stats):
        """One LM iteration, eagerly on the capture stream: the libraries'
        handles and workspaces for that stream come into being outside a
        capture."""
        stream = _capture_context(self.cam.device)[0]
        current = torch.cuda.current_stream(self.cam.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.one(stats)
        current.wait_stream(stream)
        _WARMED.add(self.kind)

    def iterate(self, max_iter, stats):
        """Up to max_iter LM iterations; returns how many were committed.
        The host reads the LM's stop before each iteration after the first,
        and the CG's once a block. With `captures`, the phases are captured
        before the first iteration that finds none, unless no problem of
        this kind has been captured on the card yet: that iteration is then
        the warm-up, and the capture comes before the next one."""
        n_iter = 0
        while n_iter < max_iter:
            if n_iter:
                stats["host_syncs"] += 1
                with span("lm.stop_read"):
                    done = bool(self.done)
                if done:
                    break
            if self.captures and self.graphs is None:
                if not n_iter and self.kind not in _WARMED:
                    with span("lm.warm_up"):
                        self.warm_up(stats)
                    n_iter += 1
                    continue
                with span("lm.capture", stats, "capture_s"):
                    self.capture(stats)
            self.one(stats)
            n_iter += 1
        return n_iter


def build_solve(residual_fn, jac_fn, n_cam, n_pts, prob, cfg, graphs=True):
    """The LM driver for one problem: run(cam, pts, max_iter, loss, f_scale,
    stats) -> (cam, pts, info).

    Counterpart of the JAX package's build_solve, whose LM and CG loops are
    two lax.while_loops in one device program. Here one LM iteration is the
    phases of _Iteration, kept per (loss, f_scale). On CUDA tensors each
    phase is a CUDA graph, captured once per problem and loss (_Iteration:
    the first problem of its kind on a card runs its first LM iteration
    eagerly as the warm-up) and replayed by every LM iteration after it, so
    that a CG block is one launch and the host reads the device once a
    block (at most ceil(CG iterations / k) + 1 reads an LM iteration; the
    graphs live as long as `run`). A capture or replay that fails raises.
    graphs=False runs the same phases eagerly on the card, one CG iteration
    a block: for checks of the graphs' bits only. On CPU tensors the phases
    always run so."""
    if not cfg.cg_iters:
        cfg = cfg._replace(cg_iters=default_cg_iters(n_cam))
    n_obs = int(prob.pts2d.shape[0])
    steps = {}

    def run(cam, pts, max_iter, loss, f_scale, stats=None):
        stats = new_stats() if stats is None else stats
        counted = ("host_syncs", "cg_iterations", "cg_masked", "matvecs", "graph_replays")
        before = {k: stats[k] for k in counted}
        with span("lm.solve", loss=loss) as solve_span:
            r0 = residual_fn(cam, pts)
            cost0 = loss_cost(loss, r0, f_scale)
            # "exactly solved" floor: 1e-14 px^2 per observation
            cost_floor = torch.clamp(1e-15 * torch.clamp(cost0, min=1.0), min=1e-14 * n_obs)
            key = (loss, float(f_scale))
            if key not in steps:
                steps[key] = _Iteration(residual_fn, jac_fn, n_cam, n_pts, prob, cfg, loss,
                                        f_scale, cam, pts, graphs and cam.device.type == "cuda")
            step = steps[key]
            step.fill(cam, pts, cost0, cost_floor)
            n_iter = step.iterate(max_iter, stats)
            cam, pts = step.cam.clone(), step.pts.clone()
            r_fin = residual_fn(cam, pts)
            w = prob.weights[:, None]
            errs = torch.stack([torch.linalg.norm(r0 / w, dim=1),
                                torch.linalg.norm(r_fin / w, dim=1)]).to(torch.float32)
            with span("lm.result_read"):
                scalars = torch.stack([step.lam, step.cost, cost0]).cpu().numpy()
                errs = errs.cpu().numpy()
            solve_span.attrs.update({k: stats[k] - before[k] for k in counted},
                                    iterations=n_iter)
        info = {
            "cost0": float(scalars[2]),
            "cost": float(scalars[1]),
            "err0": errs[0],
            "err_fin": errs[1],
            "iterations": n_iter,
            "lambda": float(scalars[0]),
        }
        info.update(stats)
        return cam, pts, info

    return run


def solve(residual_fn, jac_fn, cam0, pts0, prob, cfg, stats=None):
    """Full LM solve from (cam0, pts0) through a build_solve of its own (on
    CUDA tensors its graphs serve this solve alone). Returns (cam, pts,
    info); info holds cost0/cost, per-observation errors err0/err_fin,
    iterations, lambda and the counters of new_stats()."""
    run = build_solve(residual_fn, jac_fn, cam0.shape[0], pts0.shape[0], prob, cfg)
    return run(cam0, pts0, cfg.max_iter, cfg.loss, cfg.f_scale, stats=stats)
