"""The plain reference of the robust BA stage (soft-L1, outliers, L2), in
plain torch and in the dtype asked for. It imports nothing of the program
and takes only the inputs the benchmark made. On ba_lm's problem and its
exact step (the reduced camera system assembled densely, factored by
Cholesky) it adds:

- `solve_soft_l1`: the optimum of the soft-L1 cost, rho(z) = 2 (sqrt(1 + z)
  - 1), z = (r / f_scale)^2 for each residual component, the residuals and
  Jacobians scaled as scipy.optimize.least_squares scales them (second
  order: J by sqrt(rho' + 2 rho'' z), r by rho' over that);
- `kept_rows`: the outlier rule of the upstream project, written anew: each
  camera's threshold at the elbow of its sorted errors (the point furthest
  from the chord) if the elbow lies at or above the 80th percentile, at
  least min_thr, else the camera's largest error; the observations above it
  removed; the tracks kept that keep >= 2 observations and a listed pair of
  their cameras (a dense cameras x cameras table of the pairs);
- `kept_problem`: the problem restricted to a kept table, whose L2 optimum
  ba_lm.solve gives.
"""

import numpy as np
import torch

from portbench.reference import ba_lm

EPS = float(np.finfo(float).eps)


def soft_l1(z):
    """rho, rho', rho'' of the soft-L1 loss at z (scipy's soft_l1)."""
    t = 1.0 + z
    return 2.0 * (torch.sqrt(t) - 1.0), t ** -0.5, -0.5 * t ** -1.5


def robust_cost(r, f_scale):
    """scipy's cost: 0.5 f_scale^2 sum rho((r / f_scale)^2)."""
    return 0.5 * f_scale ** 2 * float(soft_l1((r / f_scale) ** 2)[0].sum())


def solve_soft_l1(prob, f_scale=1.0, max_iter=100, rtol=1e-12, lam=1e-3):
    """The optimum of the soft-L1 cost over the cameras' rotations and the
    points, from zero rotations and the initial points, by ba_lm.solve's
    Levenberg-Marquardt with each step on the scaled residuals and
    Jacobians. Returns (camera rows (M, 9), points (N, 3)): the optimum
    where it stops by rtol, else its state after max_iter steps."""
    m, dev, dt = prob.n_cam, prob.device, prob.dtype
    pk, pl = ba_lm._pairs(prob.pts_ind)
    ck, cl = prob.cam_ind[pk], prob.cam_ind[pl]
    ab = torch.arange(3, device=dev)
    flat = ((3 * ck[:, None, None] + ab[None, :, None]) * (3 * m)
            + 3 * cl[:, None, None] + ab[None, None, :]).reshape(-1)
    rot = prob.params0[:, :3].clone()
    pts = prob.pts0.clone()
    cost = robust_cost(prob.residuals(ba_lm._rows(prob, rot), pts), f_scale)
    diag = torch.arange(m, device=dev)
    for _ in range(max_iter):
        r, jc, jp = prob.linearize(rot, pts)
        z = (r / f_scale) ** 2
        _, rho1, rho2 = soft_l1(z)
        scale = torch.sqrt(torch.clamp(rho1 + 2.0 * rho2 * z, min=EPS))
        r = r * rho1 / scale
        jc, jp = jc * scale[..., None], jp * scale[..., None]
        jct, jpt = jc.transpose(1, 2), jp.transpose(1, 2)
        U = torch.zeros(m, 3, 3, dtype=dt, device=dev).index_add_(0, prob.cam_ind, jct @ jc)
        V = torch.zeros(prob.n_pts, 3, 3, dtype=dt, device=dev).index_add_(
            0, prob.pts_ind, jpt @ jp)
        W = jct @ jp
        gc = torch.zeros(m, 3, dtype=dt, device=dev).index_add_(
            0, prob.cam_ind, (jct @ r[..., None])[..., 0])
        gp = torch.zeros(prob.n_pts, 3, dtype=dt, device=dev).index_add_(
            0, prob.pts_ind, (jpt @ r[..., None])[..., 0])
        while True:
            Ud = U + lam * torch.diag_embed(torch.diagonal(U, dim1=1, dim2=2))
            Vd = V + lam * torch.diag_embed(torch.diagonal(V, dim1=1, dim2=2))
            Vinv = torch.linalg.inv(Vd)
            Y = W @ Vinv[prob.pts_ind]
            S = torch.zeros(3 * m * 3 * m, dtype=dt, device=dev)
            S.index_add_(0, flat, -(Y[pk] @ W[pl].transpose(1, 2)).reshape(-1))
            S4 = S.reshape(m, 3, m, 3)
            S4[diag, :, diag, :] += Ud
            S = S4.reshape(3 * m, 3 * m)
            rhs = gc - torch.zeros(m, 3, dtype=dt, device=dev).index_add_(
                0, prob.cam_ind, (Y @ gp[prob.pts_ind][..., None])[..., 0])
            L, info = torch.linalg.cholesky_ex(S)
            if int(info) == 0:
                dc = torch.cholesky_solve(-rhs.reshape(-1, 1), L).reshape(m, 3)
                wdc = (W.transpose(1, 2) @ dc[prob.cam_ind][..., None])[..., 0]
                gp_c = gp + torch.zeros_like(gp).index_add_(0, prob.pts_ind, wdc)
                dp = -(Vinv @ gp_c[..., None])[..., 0]
                new_cost = robust_cost(prob.residuals(ba_lm._rows(prob, rot + dc), pts + dp),
                                       f_scale)
                if new_cost < cost:
                    break
            lam *= 10.0
            if lam > 1e12:
                return ba_lm._rows(prob, rot), pts
        rot, pts = rot + dc, pts + dp
        lam = max(lam / 10.0, 1e-12)
        done = cost - new_cost <= rtol * cost
        cost = new_cost
        if done:
            break
    return ba_lm._rows(prob, rot), pts


def errors(prob, answer):
    """Each observation's reprojection error (px) at an answer (camera rows,
    points)."""
    rows, pts = (torch.as_tensor(a, device=prob.device).to(prob.dtype) for a in answer)
    return torch.linalg.norm(prob.residuals(rows, pts), dim=1)


def camera_threshold(err, min_thr=1.0, max_outliers_percent=20):
    """One camera's threshold from its errors (1-D tensor)."""
    values = torch.sort(err).values
    n = len(values)
    if n < 3:
        return float(values[-1])
    x = torch.arange(n, dtype=values.dtype, device=values.device)
    chord = torch.stack([x[-1] - x[0], values[-1] - values[0]])
    chord = chord / torch.linalg.norm(chord)
    dx, dy = x - x[0], values - values[0]
    along = dx * chord[0] + dy * chord[1]
    dist = torch.hypot(dx - along * chord[0], dy - along * chord[1])
    elbow = float(values[int(torch.argmax(dist))])
    pct = float(torch.quantile(values, 1.0 - max_outliers_percent / 100.0))
    return max(elbow, min_thr) if elbow >= pct else float(values[-1])


def kept_rows(err, cam_ind, pts_ind, n_cam, n_pts, pairs, min_thr=1.0):
    """The rows of the observation table that the outlier pass keeps, as a
    bool mask: the per-camera rule, then the track filters."""
    thr = torch.full((n_cam,), float("inf"), dtype=torch.float64)
    cams = cam_ind.cpu()  # one camera at a time, on the host
    counts = torch.bincount(cams, minlength=n_cam).tolist()
    mine = torch.split(err.cpu()[torch.argsort(cams, stable=True)], counts)
    for c in range(n_cam):
        if counts[c]:
            thr[c] = camera_threshold(mine[c], min_thr)
    thr = thr.to(err.device)
    keep = err.to(torch.float64) <= thr[cam_ind]
    left = torch.bincount(pts_ind[keep], minlength=n_pts)
    listed = torch.zeros(n_cam, n_cam, dtype=torch.bool, device=err.device)
    ij = torch.as_tensor(np.asarray(pairs, np.int64).reshape(-1, 2), device=err.device)
    ij = ij[(ij < n_cam).all(1)]
    listed[ij[:, 0], ij[:, 1]] = True
    listed[ij[:, 1], ij[:, 0]] = True
    rows = torch.nonzero(keep)[:, 0]
    k, l = ba_lm._pairs(pts_ind[rows])
    k, l = rows[k], rows[l]
    has_pair = torch.zeros(n_pts, dtype=torch.bool, device=err.device)
    has_pair[pts_ind[k][listed[cam_ind[k], cam_ind[l]]]] = True
    return keep & (left >= 2)[pts_ind] & has_pair[pts_ind]


def kept_problem(problem, rows):
    """The problem dict restricted to the observations `rows` (indices into
    its table), its tracks renumbered in increasing order. Returns (the
    problem, the kept tracks' indices in the original numbering)."""
    rows = np.asarray(rows)
    tracks, pts_ind = np.unique(np.asarray(problem["pts_ind"])[rows], return_inverse=True)
    return dict(problem, cam_ind=np.asarray(problem["cam_ind"])[rows], pts_ind=pts_ind,
                pts2d=np.asarray(problem["pts2d"])[rows],
                pts0=np.asarray(problem["pts0"])[tracks]), tracks
