"""The plain reference of the CLI scene: what the CLI wrote, judged from its files.

The views were rendered through known RPCs, on a ground plane at a known
altitude, and handed to the CLI with biased RPCs. The reference reads what
the CLI wrote under its `<output_dir>/<ba_method>/`: the keypoints
(`matches/features/<id>.npy`), the pairwise matches (`matches/matches.npy`,
rows kp_i, kp_j, im_i, im_j over the images of `matches/filenames.txt`),
the adjusted RPCs (`rpcs_adj/<id>.rpc_adj`) and the points
(`pts3d_adj.ply`). It joins the matches into tracks itself (connected
components; a component with two keypoints of one view is no track),
triangulates each track through the adjusted RPCs (Gauss-Newton in lon,
lat, alt) and gives:

- `reproj_px`: the mean reprojection error of the tracks' observations at
  those points;
- `ply_m`: the mean distance from a point of the .ply to the nearest point
  that the reference triangulated;
- `bias_px`: the worst view's RMS gap, at ground points of the rendered
  plane, between its adjusted RPC and its true one, once the one 3-D
  translation of the ground that fits all views best is taken out (the
  problem's gauge: a common shift, and the altitude that trades with each
  view's parallax);
- `pair_matches_min`: the fewest matches of any pair of views;
- `view_tracks_min`: the fewest tracks that one view sees.

`rounding` rounds what the CLI wrote before it is judged: the control, in
the precision below the one that the configuration states for it.
"""

import os

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from portbench.scenes import rpc as rpcm

F64 = torch.float64
GN_STEPS = 8


def read_ply(path):
    """(N, 3) float64 points of an ASCII .ply."""
    with open(path) as f:
        lines = f.read().splitlines()
    body = lines[lines.index("end_header") + 1:]
    return np.array([[float(v) for v in line.split()[:3]] for line in body if line.strip()])


def _round(a, dtype):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=F64).to(dtype).to(F64)


def _rpc(rpc, dtype=F64):
    return {k: _round(rpc[k], dtype) for k in rpcm.FIELDS}


def _id(path):
    return os.path.splitext(os.path.basename(path.strip()))[0]


def tracks(keypoints, matches):
    """(T, V) keypoint index of each track in each view (-1: unseen), from
    the (K, 4) matches over V views of keypoints[v] (n_v, 2)."""
    offs = np.concatenate([[0], np.cumsum([len(k) for k in keypoints])])
    view = np.repeat(np.arange(len(keypoints)), np.diff(offs))
    a, b = offs[matches[:, 2]] + matches[:, 0], offs[matches[:, 3]] + matches[:, 1]
    n = int(offs[-1])
    _, label = connected_components(coo_matrix((np.ones(len(a)), (a, b)), shape=(n, n)),
                                    directed=False)
    size = np.bincount(label, minlength=n)
    nodes = np.where(size[label] >= 2)[0]
    lab, inv = np.unique(label[nodes], return_inverse=True)
    table = np.full((len(lab), len(keypoints)), -1, np.int64)
    seen = np.zeros((len(lab), len(keypoints)), np.int64)
    np.add.at(seen, (inv, view[nodes]), 1)
    twice = (seen > 1).any(1)
    table[inv, view[nodes]] = nodes - offs[view[nodes]]
    return table[~twice]


def triangulate(rpcs, obs, seen, alt0):
    """(lon, lat, alt) of each track (T,) minimizing its reprojection error
    through rpcs; obs (V, T, 2) pixels, seen (V, T) bool."""
    v0 = seen.float().argmax(0)
    first = obs[v0, torch.arange(obs.shape[1])]
    lon = torch.zeros(obs.shape[1], dtype=F64)
    lat = torch.zeros_like(lon)
    for v, r in enumerate(rpcs):  # start: the first view's ray at alt0
        m = v0 == v
        lon[m], lat[m] = rpcm.localize(r, first[m, 0], first[m, 1], torch.full_like(lon[m], alt0))
    x = torch.stack([lon, lat, torch.full_like(lon, alt0)], 1)
    scale = torch.tensor([1e-5, 1e-5, 1.0], dtype=F64)  # about a pixel's worth of each

    def residuals(u):
        g = x + u * scale
        return torch.stack([torch.stack(rpcm.project(r, g[:, 0], g[:, 1], g[:, 2]), 1) - obs[v]
                            for v, r in enumerate(rpcs)]) * seen[..., None]

    for _ in range(GN_STEPS):
        u = torch.zeros_like(x)
        r = residuals(u)
        cols = [torch.func.jvp(residuals, (u,), (torch.eye(3, dtype=F64)[d].expand_as(u),))[1]
                for d in range(3)]
        j = torch.stack(cols, -1)  # (V, T, 2, 3)
        jtj = torch.einsum("vtki,vtkj->tij", j, j)
        jtr = torch.einsum("vtki,vtk->ti", j, r)
        x = x - torch.linalg.solve(jtj, jtr) * scale
    err = residuals(torch.zeros_like(x)).norm(dim=-1)
    return x, err[seen]


def bias(adj, true, h, w, alt, n=16):
    """The worst view's RMS gap (px) between adj and true at ground points
    of the plane `alt`, after the common 3-D translation that fits best."""
    g = torch.linspace(0.05, 0.95, n, dtype=F64)
    lon, lat = rpcm.localize(true[0], (g * w).repeat(n), (g * h).repeat_interleave(n),
                             torch.full((n * n,), float(alt), dtype=F64))
    alt = torch.full_like(lon, float(alt))
    step = (1e-6, 1e-6, 1.0)

    def proj(r, d=None, e=0.0):
        pt = [lon, lat, alt]
        if d is not None:
            pt[d] = pt[d] + e
        return torch.stack(rpcm.project(r, *pt), 1)

    gap = torch.stack([proj(a) - proj(t) for a, t in zip(adj, true)])  # (V, X, 2)
    jac = torch.stack([torch.stack([(proj(t, d, step[d]) - proj(t)) / step[d]
                                    for d in range(3)], -1) for t in true])  # (V, X, 2, 3)
    shift = torch.linalg.lstsq(jac.reshape(-1, 3), gap.reshape(-1, 1)).solution
    left = gap - (jac @ shift).squeeze(-1)
    return float(left.norm(dim=-1).pow(2).mean(1).sqrt().max())


def judge(ba_dir, view_of, true_rpcs, h, w, alt, rounding=(F64, torch.float32)):
    """The numbers of one scene. view_of: image id -> view index of the
    rendered views; true_rpcs: their dict RPCs, in view order; rounding: the
    dtypes that the geometry (RPCs, points) and the keypoint coordinates are
    rounded to before they are judged."""
    geo, kp = rounding
    mdir = os.path.join(ba_dir, "matches")
    with open(os.path.join(mdir, "filenames.txt")) as f:
        ids = [_id(line) for line in f if line.strip()]
    n = len(true_rpcs)
    if sorted(view_of[i] for i in ids) != list(range(n)):
        raise ValueError("the CLI's images {} are not the {} views".format(ids, n))
    keypoints = []
    for i in ids:
        feats = np.load(os.path.join(mdir, "features", i + ".npy"))
        keypoints.append(_round(feats[np.isfinite(feats[:, 0]), :2], kp))
    matches = np.load(os.path.join(mdir, "matches.npy")).astype(np.int64).reshape(-1, 4)
    views = np.array([view_of[i] for i in ids])
    per_pair = np.zeros((n, n), np.int64)
    np.add.at(per_pair, (np.minimum(views[matches[:, 2]], views[matches[:, 3]]),
                         np.maximum(views[matches[:, 2]], views[matches[:, 3]])), 1)
    table = tracks([k.numpy() for k in keypoints], matches)
    seen = torch.as_tensor(table >= 0).T  # (V, T)
    obs = torch.stack([k[torch.as_tensor(np.maximum(t, 0))] for k, t in zip(keypoints, table.T)])
    adj = [_rpc(rpcm.read_file(os.path.join(ba_dir, "rpcs_adj", i + ".rpc_adj")), geo) for i in ids]
    pts, err = triangulate(adj, obs, seen, alt)
    ply = _round(read_ply(os.path.join(ba_dir, "pts3d_adj.ply")), geo)
    mine = rpcm.latlon_to_ecef(pts[:, 1], pts[:, 0], pts[:, 2])
    near = torch.cat([torch.cdist(c, mine).min(1).values for c in ply.split(4096)])
    true = [_rpc(true_rpcs[view_of[i]]) for i in ids]
    return {"reproj_px": float(err.mean()), "ply_m": float(near.mean()),
            "bias_px": bias(adj, true, h, w, alt),
            "pair_matches_min": int(per_pair[np.triu_indices(n, 1)].min()),
            "view_tracks_min": int(seen.sum(1).min())}
