"""The plain reference of the BA stage: a Levenberg-Marquardt solve of the
rpc bundle adjustment (rotations of the cameras and the points) with an
exact step, the reduced camera system assembled densely and factored by
Cholesky, in plain torch and in the dtype asked for. It imports nothing of
the program and takes only the inputs the benchmark made.

`compare` judges an answer (corrected camera rows and points) against the
reference's optimum by quantities that do not depend on the problem's
gauge: the excess of its cost over the optimum's, and the largest RMS gap
between its residuals and the optimum's over the observations of one
camera.
"""

import torch

from portbench.scenes import rpc as rpcm


class Problem:
    """The observation table on a device, in a dtype."""

    def __init__(self, problem, dtype, device, chunk=1 << 18):
        def t(a, dt=dtype):
            return torch.as_tensor(a, dtype=dt, device=device)

        self.dtype, self.device, self.chunk = dtype, device, chunk
        self.rpcs = rpcm.stack(problem["rpcs"], dtype=dtype, device=device)
        self.params0 = t(problem["params0"])
        self.cam_ind = t(problem["cam_ind"], torch.int64)
        self.pts_ind = t(problem["pts_ind"], torch.int64)
        self.obs = t(problem["pts2d"])
        self.n_cam, self.n_pts = len(problem["rpcs"]), len(problem["pts0"])
        self.pts0 = t(problem["pts0"])

    def _chunks(self):
        k = len(self.obs)
        for s in range(0, k, self.chunk):
            yield slice(s, min(k, s + self.chunk))

    def _fn(self, c, tail=None):
        cam = self.cam_ind[c]
        rpcs, obs = rpcm.index(self.rpcs, cam), self.obs[c]
        tail = self.params0[cam, 3:] if tail is None else tail[cam]
        return lambda rot, pts: rpcm.project_corrected(rpcs, pts, torch.cat([rot, tail], 1)) - obs

    def residuals(self, rows, pts):
        """(K, 2) projection minus observation, for camera rows (M, 9)."""
        return torch.cat([self._fn(c, rows[:, 3:])(rows[self.cam_ind[c], :3], pts[self.pts_ind[c]])
                          for c in self._chunks()])

    def linearize(self, rot, pts):
        """Residuals (K, 2) and the Jacobians (K, 2, 3) in the camera's
        rotation and in the point, by forward-mode derivatives."""
        rs, jc, jp = [], [], []
        for c in self._chunks():
            a, b = rot[self.cam_ind[c]], pts[self.pts_ind[c]]
            cols = []
            for d in range(6):
                ta, tb = torch.zeros_like(a), torch.zeros_like(b)
                (ta if d < 3 else tb)[:, d % 3] = 1
                r, jd = torch.func.jvp(self._fn(c), (a, b), (ta, tb))
                cols.append(jd)
            rs.append(r)
            j = torch.stack(cols, dim=-1)
            jc.append(j[..., :3])
            jp.append(j[..., 3:])
        return torch.cat(rs), torch.cat(jc), torch.cat(jp)


def _pairs(pts_ind):
    """Every ordered pair (k, l) of observations of one point."""
    order = torch.argsort(pts_ind, stable=True)
    sorted_pts = pts_ind[order]
    counts = torch.bincount(sorted_pts)
    starts = torch.cumsum(counts, 0) - counts
    width = int(counts.max())
    slot = torch.arange(len(order), device=pts_ind.device) - starts[sorted_pts]
    table = torch.full((len(counts), width), -1, dtype=torch.int64, device=pts_ind.device)
    table[sorted_pts, slot] = order
    k = table[:, :, None].expand(-1, width, width).reshape(-1)
    l = table[:, None, :].expand(-1, width, width).reshape(-1)
    keep = (k >= 0) & (l >= 0)
    return k[keep], l[keep]


def solve(prob, max_iter=100, rtol=1e-12, lam=1e-3):
    """The optimum of the L2 cost over the cameras' rotations and the
    points, from zero rotations and the initial points. Returns (camera rows
    (M, 9), points (N, 3)) in the problem's dtype."""
    m, dev, dt = prob.n_cam, prob.device, prob.dtype
    pk, pl = _pairs(prob.pts_ind)
    ck, cl = prob.cam_ind[pk], prob.cam_ind[pl]
    ab = torch.arange(3, device=dev)
    flat = ((3 * ck[:, None, None] + ab[None, :, None]) * (3 * m)
            + 3 * cl[:, None, None] + ab[None, None, :]).reshape(-1)
    rot = prob.params0[:, :3].clone()
    pts = prob.pts0.clone()
    cost = 0.5 * float((prob.residuals(_rows(prob, rot), pts) ** 2).sum())
    diag = torch.arange(m, device=dev)
    for _ in range(max_iter):
        r, jc, jp = prob.linearize(rot, pts)
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
                new_cost = 0.5 * float((prob.residuals(_rows(prob, rot + dc), pts + dp) ** 2).sum())
                if new_cost < cost:
                    break
            lam *= 10.0
            if lam > 1e12:
                return _rows(prob, rot), pts
        rot, pts = rot + dc, pts + dp
        lam = max(lam / 10.0, 1e-12)
        done = cost - new_cost <= rtol * cost
        cost = new_cost
        if done:
            break
    return _rows(prob, rot), pts


def _rows(prob, rot):
    return torch.cat([rot, prob.params0[:, 3:]], 1)


def compare(prob, answer, optimum):
    """The numbers by which an answer (camera rows (M, 9), points (N, 3);
    any float dtype) is judged against the optimum, both evaluated in
    float64: cost_excess, the answer's L2 cost over the optimum's, less 1;
    cam_gap_px, the largest RMS over one camera's observations of the
    difference between the two residual vectors (px)."""
    f64 = torch.float64
    (cam_a, pts_a), (cam_o, pts_o) = [(torch.as_tensor(c, device=prob.device).to(f64),
                                       torch.as_tensor(p, device=prob.device).to(f64))
                                      for c, p in (answer, optimum)]
    r_a, r_o = prob.residuals(cam_a, pts_a), prob.residuals(cam_o, pts_o)
    gap = torch.zeros(prob.n_cam, dtype=f64, device=prob.device).index_add_(
        0, prob.cam_ind, ((r_a - r_o) ** 2).sum(1))
    n = torch.bincount(prob.cam_ind, minlength=prob.n_cam).clamp(min=1)
    return {"cost_excess": float((r_a ** 2).sum() / (r_o ** 2).sum() - 1.0),
            "cam_gap_px": float(torch.sqrt(gap / n).max())}
