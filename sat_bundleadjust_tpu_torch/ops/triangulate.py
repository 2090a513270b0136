"""Batched tie-point triangulation.

Counterpart of `sat_bundleadjust_tpu/ops/triangulate.py`. Every (pair,
track) observation duo across all stereo pairs is triangulated in one
batch: with RPC cameras by the reference's altitude search (secant along
the epipolar curve, hstep 1, stop at |lambda| < 1e-5, at most 24 steps),
with converged duos frozen; with 3x4 matrix cameras (affine, perspective)
by the linear (DLT) method, one batched 4x4 SVD. The per-track mean over
pairs is a segment mean on the host.
"""

import os

import numpy as np
import torch

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.models import ellipsoid
from sat_bundleadjust_tpu_torch.models.rpc import index_rpc, rpc_localization, rpc_projection, stack_rpcs
from sat_bundleadjust_tpu_torch.utils.profiling import span

RPCH_ITERS = 24
RPCH_HSTEP = 1.0
RPCH_LAMBDA_STOP = 1e-5
CHUNK = 500_000  # duos per batch (SATBA_TRIANG_CHUNK): bounds the device temporaries


def _pair_correspondence(rpc_a, rpc_b, x, y, h):
    """Pixel (x=col, y=row) of image a at altitude h, seen in image b."""
    lon, lat = rpc_localization(rpc_a, x, y, h)
    return rpc_projection(rpc_b, lon, lat, h)


def rpc_triangulation(rpc_a, rpc_b, pts_a, pts_b):
    """Triangulate matched pixels (..., 2) between RPC cameras a and b
    (fields batched like the points). Returns pts3d (..., 3) ECEF and the
    residual distance in image b (px). Stops early once every duo has
    converged (one host sync per step: the `triangulate.rpc` span's
    `host_reads`)."""
    xa, ya = pts_a[..., 0], pts_a[..., 1]
    xb, yb = pts_b[..., 0], pts_b[..., 1]
    h = torch.zeros_like(xa)
    err = torch.zeros_like(xa)
    done = torch.zeros_like(xa, dtype=torch.bool)
    with span("triangulate.rpc", duos=int(xa.numel())) as loop:
        reads = 0
        for _ in range(RPCH_ITERS):
            reads += 1
            if bool(done.all()):
                break
            px, py = _pair_correspondence(rpc_a, rpc_b, xa, ya, h)
            qx, qy = _pair_correspondence(rpc_a, rpc_b, xa, ya, h + RPCH_HSTEP)
            ax, ay = qx - px, qy - py
            bx, by = xb - px, yb - py
            a2 = ax * ax + ay * ay
            lam = (ax * bx + ay * by) / torch.where(a2 == 0, torch.ones_like(a2), a2)
            zx, zy = px + lam * ax, py + lam * ay
            new_err = torch.hypot(zx - xb, zy - yb)
            h = torch.where(done, h, h + lam * RPCH_HSTEP)
            err = torch.where(done, err, new_err)
            done = done | (lam.abs() < RPCH_LAMBDA_STOP)
        loop.attrs["host_reads"] = reads
    lon, lat = rpc_localization(rpc_a, xa, ya, h)
    return ellipsoid.latlon_to_ecef_arr(lat, lon, h), err


def linear_triangulation(P1, P2, pts1, pts2):
    """DLT triangulation of matched pixels (..., 2) with 3x4 projection
    matrices P1, P2 (shared, or batched like the points): the right
    singular vector of the stacked 4x4 system, dehomogenized -> (..., 3)."""

    def rows(P, pts):
        P = P.expand(pts.shape[:-1] + (3, 4)) if P.dim() == 2 else P
        return torch.stack([pts[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                            pts[..., 1:2] * P[..., 2, :] - P[..., 1, :]], dim=-2)

    A = torch.cat([rows(P1, pts1), rows(P2, pts2)], dim=-2)  # (..., 4, 4)
    X = torch.linalg.svd(A).Vh[..., -1, :]
    return X[..., :3] / X[..., 3:4]


def build_triangulation_batch(C, pairs_to_triangulate):
    """Flatten (pair, track) observation duos of C (2M, N) into one batch:
    dict of cam_a, cam_b (B,), pts_a, pts_b (B, 2), track (B,); None when
    there is no duo."""
    n_cam = C.shape[0] // 2
    mask = ~np.isnan(C[::2])
    cam_a, cam_b, pa, pb, track = [], [], [], [], []
    for (ci, cj) in pairs_to_triangulate:
        if ci >= n_cam or cj >= n_cam:
            continue
        sel = np.where(mask[ci] & mask[cj])[0]
        if sel.size == 0:
            continue
        cam_a.append(np.full(sel.size, ci, dtype=np.int32))
        cam_b.append(np.full(sel.size, cj, dtype=np.int32))
        pa.append(C[2 * ci: 2 * ci + 2, sel].T)
        pb.append(C[2 * cj: 2 * cj + 2, sel].T)
        track.append(sel.astype(np.int32))
    if not cam_a:
        return None
    return {
        "cam_a": np.concatenate(cam_a),
        "cam_b": np.concatenate(cam_b),
        "pts_a": np.concatenate(pa, axis=0),
        "pts_b": np.concatenate(pb, axis=0),
        "track": np.concatenate(track),
    }


def init_pts3d(C, cameras, cam_model, pairs_to_triangulate, verbose=False, device=None):
    """One 3-D point per track of C: the mean of its pairwise
    triangulations ((N, 3) numpy, zeros for tracks without a pair).
    cameras: RPCModels (cam_model "rpc") or 3x4 matrices."""
    dev = resolve_device(device)
    n_pts = C.shape[1]
    with span("triangulate.batch"):
        batch = build_triangulation_batch(C, pairs_to_triangulate)
    if batch is None:
        return np.zeros((n_pts, 3))
    if cam_model == "rpc":
        rpcs = stack_rpcs(cameras, dev)
    else:
        mats = torch.as_tensor(np.stack([np.asarray(c, np.float64) for c in cameras]),
                               device=dev)
    B = int(batch["track"].shape[0])
    chunk = int(os.environ.get("SATBA_TRIANG_CHUNK", CHUNK))
    sums = np.zeros((n_pts, 3))
    with span("triangulate.loop", duos=B, chunks=-(-B // chunk)):
        for s in range(0, B, chunk):
            sl = slice(s, min(s + chunk, B))
            cam_a = torch.as_tensor(batch["cam_a"][sl], dtype=torch.int64, device=dev)
            cam_b = torch.as_tensor(batch["cam_b"][sl], dtype=torch.int64, device=dev)
            pts_a = torch.as_tensor(batch["pts_a"][sl], dtype=torch.float64, device=dev)
            pts_b = torch.as_tensor(batch["pts_b"][sl], dtype=torch.float64, device=dev)
            if cam_model == "rpc":
                pts3d, _ = rpc_triangulation(index_rpc(rpcs, cam_a), index_rpc(rpcs, cam_b),
                                             pts_a, pts_b)
            else:
                pts3d = linear_triangulation(mats[cam_a], mats[cam_b], pts_a, pts_b)
            # deterministic host-side segment sum, in duo order
            np.add.at(sums, batch["track"][sl], pts3d.cpu().numpy())
    counts = np.bincount(batch["track"], minlength=n_pts).astype(np.float64)
    return sums / np.maximum(counts, 1.0)[:, None]
