"""Batched tie-point triangulation.

Counterpart of `sat_bundleadjust_tpu/ops/triangulate.py`. Every (pair,
track) observation duo across all stereo pairs is triangulated in one
batch: with RPC cameras by the reference's altitude search (secant along
the epipolar curve, hstep 1, stop at |lambda| < 1e-5, at most 24 steps;
`rpc_triangulate`: on the card one launch of csrc/rpc_triangulate.cu, on
the CPU the plain version `rpc_triangulation`, with converged duos
frozen); with 3x4 matrix cameras (affine, perspective) by the linear (DLT)
method, one batched 4x4 SVD. The duos come from the
observation table on the device, by a key lookup of each track's camera
pairs in the pairs list (`observation_duos`), and the per-track mean is a
segment sum whose order does not depend on the device (`segment_mean`).
`init_pts3d` takes the tracks layer's correspondence matrix C and reads it
into that table.
"""

import ctypes
import itertools
import os

import numpy as np
import torch

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.models import ellipsoid
from sat_bundleadjust_tpu_torch.models.rpc import (NEWTON_ITERS, index_rpc, map_rpc,
                                                   rpc_localization, rpc_projection, stack_rpcs)
from sat_bundleadjust_tpu_torch.ops import _build
from sat_bundleadjust_tpu_torch.utils.profiling import span

RPCH_ITERS = 24
RPCH_HSTEP = 1.0
RPCH_LAMBDA_STOP = 1e-5
CHUNK = 500_000  # duos a batch of the plain versions (SATBA_TRIANG_CHUNK): bounds their temporaries


def count_read(reads):
    """One read of the device, added to reads["host_reads"] where reads (a
    span's attributes) is given."""
    if reads is not None:
        reads["host_reads"] = reads.get("host_reads", 0) + 1


def host_read(t, reads=None):
    """t on the host (a number, or a numpy array): a read of the device,
    counted in reads (count_read)."""
    count_read(reads)
    return t.item() if t.dim() == 0 else t.cpu().numpy()


def true_rows(mask, reads=None):
    """The indices of mask's true entries, (n,) int64: a read of the device
    (their count), counted in reads (count_read)."""
    count_read(reads)
    return torch.nonzero(mask)[:, 0]


def _pair_correspondence(rpc_a, rpc_b, x, y, h):
    """Pixel (x=col, y=row) of image a at altitude h, seen in image b."""
    lon, lat = rpc_localization(rpc_a, x, y, h)
    return rpc_projection(rpc_b, lon, lat, h)


def rpc_triangulation(rpc_a, rpc_b, pts_a, pts_b, reads=None):
    """Triangulate matched pixels (..., 2) between RPC cameras a and b
    (fields batched like the points). Returns pts3d (..., 3) ECEF and the
    residual distance in image b (px). Stops early once every duo has
    converged (one host sync per step: the `triangulate.rpc` span's
    `host_reads`, also counted in reads where given)."""
    xa, ya = pts_a[..., 0], pts_a[..., 1]
    xb, yb = pts_b[..., 0], pts_b[..., 1]
    h = torch.zeros_like(xa)
    err = torch.zeros_like(xa)
    done = torch.zeros_like(xa, dtype=torch.bool)
    with span("triangulate.rpc", duos=int(xa.numel()), route="plain") as loop:
        for _ in range(RPCH_ITERS):
            count_read(reads)
            if host_read(done.all(), loop.attrs):
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
    lon, lat = rpc_localization(rpc_a, xa, ya, h)
    return ellipsoid.latlon_to_ecef_arr(lat, lon, h), err


def _plain_chunk():
    """Duos a batch of the plain versions (SATBA_TRIANG_CHUNK, default CHUNK)."""
    return int(os.environ.get("SATBA_TRIANG_CHUNK", CHUNK))


_SIGNATURES = {
    "rpc_triangulate": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                           ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p]),
}


def _rpc_kernel(rpcs, cam_a, cam_b, pts_a, pts_b):
    """One launch of csrc/rpc_triangulate.cu over the D duos on the card:
    (5, D) float64, rows lon, lat, h, err and the secant steps taken (NaN
    for a camera index outside the table). The duos go to the threads in
    the order of cam_a (a warp's coefficient reads broadcast); each result
    goes back to its duo's index. Raises on what the kernel does not take
    and on the CUDA error of the launch."""
    dev = pts_a.device
    D = pts_a.shape[0]
    for name, t in (("cam_a", cam_a), ("cam_b", cam_b)):
        if t.device != dev or t.dtype not in (torch.int32, torch.int64) or t.shape != (D,):
            raise ValueError("rpc_triangulate: {} must be ({},) integers on {}".format(
                name, D, dev))
    if pts_b.device != dev or pts_b.shape != (D, 2) or pts_a.shape != (D, 2) \
            or pts_a.dtype != torch.float64 or pts_b.dtype != torch.float64:
        raise ValueError("rpc_triangulate: pts_a and pts_b must be (D, 2) float64 on one device")
    M = rpcs.line_num.shape[0]
    for k, (name, f) in enumerate(zip(rpcs._fields, rpcs)):
        if f.device != dev or f.dtype != torch.float64 or f.shape != ((M, 20) if k < 4 else (M,)):
            raise ValueError("rpc_triangulate: the table's {} must be float64, {} on {}".format(
                name, "(M, 20)" if k < 4 else "(M,)", dev))
    out = torch.empty((5, D), dtype=torch.float64, device=dev)
    if D == 0:
        return out
    table = torch.cat([*rpcs[:4], torch.stack(rpcs[4:], dim=1)], dim=1)  # (M, 90), field order
    order = torch.argsort(cam_a)
    cam_a, cam_b = (t.to(torch.int64).contiguous() for t in (cam_a, cam_b))
    pts_a, pts_b = pts_a.contiguous(), pts_b.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.load("rpc_triangulate", _SIGNATURES).rpc_triangulate(
        table.data_ptr(), M, order.data_ptr(), cam_a.data_ptr(), cam_b.data_ptr(),
        pts_a.data_ptr(), pts_b.data_ptr(), D, RPCH_ITERS, NEWTON_ITERS, RPCH_HSTEP,
        RPCH_LAMBDA_STOP, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("rpc_triangulate kernel launch failed: CUDA error {}".format(err))
    rpc_triangulate.launches += 1
    return out


def rpc_triangulate(rpcs, cam_a, cam_b, pts_a, pts_b, reads=None):
    """Triangulate D duos between the cameras of a stacked RPC table (an
    RPCModel of float64 (M, 20) and (M,) fields, as stack_rpcs gives it):
    duo k is pts_a[k] (x=col, y=row) in camera cam_a[k] matched with
    pts_b[k] in camera cam_b[k] ((D,) int32 or int64, (D, 2) float64). Returns pts3d
    (D, 3) ECEF and the residual distance in image b (D,) px.

    CUDA tensors launch csrc/rpc_triangulate.cu once over all D duos or
    raise, with no read of the device; each launch adds one to
    rpc_triangulate.launches. CPU tensors take the plain version:
    index_rpc and rpc_triangulation, _plain_chunk() duos at a time, its
    host reads counted in reads. The `triangulate.rpc` span says which
    (`route` "kernel" or "plain")."""
    dev = pts_a.device
    if dev.type == "cpu":
        chunk = _plain_chunk()
        parts = [rpc_triangulation(index_rpc(rpcs, cam_a[s:s + chunk]),
                                   index_rpc(rpcs, cam_b[s:s + chunk]),
                                   pts_a[s:s + chunk], pts_b[s:s + chunk], reads)
                 for s in range(0, max(pts_a.shape[0], 1), chunk)]
        return tuple(torch.cat(t) for t in zip(*parts))
    if dev.type != "cuda":
        raise ValueError("rpc_triangulate: unsupported device {}".format(dev))
    with span("triangulate.rpc", duos=int(pts_a.shape[0]), route="kernel", host_reads=0):
        lon, lat, h, err, _ = _rpc_kernel(rpcs, cam_a, cam_b, pts_a, pts_b)
    return ellipsoid.latlon_to_ecef_arr(lat, lon, h), err


rpc_triangulate.launches = 0


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


def pair_lookup(pairs_to_triangulate, n_cam, device):
    """The listed pairs with both cameras below n_cam, for a key lookup:
    (keys, first) on device, keys = min(i, j) * n_cam + max(i, j) sorted
    (stably, so a pair listed twice keeps its order) and first = the first
    camera of each listed pair in that order."""
    # flattened without a Python object per pair: ~470 000 pairs at 1000 views
    pairs = np.fromiter(itertools.chain.from_iterable(pairs_to_triangulate), np.int64,
                        count=2 * len(pairs_to_triangulate)).reshape(-1, 2)
    pairs = pairs[(pairs < n_cam).all(axis=1)]
    keys = pairs.min(axis=1) * n_cam + pairs.max(axis=1)
    order = np.argsort(keys, kind="stable")
    return (torch.as_tensor(keys[order], device=device),
            torch.as_tensor(pairs[order, 0], device=device))


def _candidates(pts_ind, cam_ind, n_pts, n_cam, lookup, reads=None):
    """Every unordered duo (u, v), u <= v, of the observations of one
    track, in (u, v) order, and the listed pairs of its cameras: (u, v, lo,
    n), the listed pairs being lookup's [lo, lo + n). The table is sorted by
    point (pts_ind non-decreasing). One host read (the duos' count),
    counted in reads."""
    dev = pts_ind.device
    K = pts_ind.numel()
    end = torch.cumsum(torch.bincount(pts_ind, minlength=n_pts), 0)[pts_ind]
    rows = torch.arange(K, device=dev)
    per_row = end - rows  # v in [u, end of u's track)
    total = host_read(per_row.sum(), reads)
    u = torch.repeat_interleave(rows, per_row, output_size=total)
    v = u + torch.arange(total, device=dev) - (torch.cumsum(per_row, 0) - per_row)[u]
    ca, cb = cam_ind[u], cam_ind[v]
    key = torch.minimum(ca, cb) * n_cam + torch.maximum(ca, cb)
    keys = lookup[0]
    lo = torch.searchsorted(keys, key)
    return u, v, lo, torch.searchsorted(keys, key, right=True) - lo


def tracks_with_a_pair(pts_ind, cam_ind, n_pts, n_cam, lookup, reads=None):
    """(n_pts,) bool: the tracks of the table (sorted by point) that some
    listed pair of their cameras observes (for the pair (i, i), a track
    that camera i observes): m^T P m > 0, m the track's cameras and P the
    listed pairs. lookup: pair_lookup's; its read counted in reads."""
    u, _, _, n = _candidates(pts_ind, cam_ind, n_pts, n_cam, lookup, reads)
    hits = torch.zeros(n_pts, dtype=torch.int64, device=pts_ind.device)
    return hits.index_add_(0, pts_ind[u], n) > 0


def observation_duos(pts_ind, cam_ind, n_pts, n_cam, lookup, reads=None):
    """The (pair, track) observation duos of the table (sorted by point),
    from it by a key lookup: for every listed pair (i, j) and every track
    that both cameras observe, the rows (a, b) of its observations in i and
    in j. Ordered by track, then by (u, v) within the track, then as
    listed. Returns (a, b) (D,) int64; its two reads counted in reads."""
    u, v, lo, n = _candidates(pts_ind, cam_ind, n_pts, n_cam, lookup, reads)
    total = host_read(n.sum(), reads)
    c = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n, output_size=total)
    listed = lo[c] + torch.arange(total, device=n.device) - (torch.cumsum(n, 0) - n)[c]
    u, v = u[c], v[c]
    forward = lookup[1][listed] == cam_ind[u]
    return torch.where(forward, u, v), torch.where(forward, v, u)


def segment_mean(values, seg, n_seg, reads=None):
    """Mean of values (D, ...) over segments seg (D,), sorted, (n_seg, ...)
    (zeros for an empty segment), summed in the values' order whatever the
    device: the k-th value of every segment is added in the k-th
    index_add_, whose targets are distinct (one host read, the count of
    each k, counted in reads)."""
    counts = torch.bincount(seg, minlength=n_seg)
    slot = torch.arange(seg.numel(), device=seg.device) - (torch.cumsum(counts, 0) - counts)[seg]
    order = torch.sort(slot, stable=True).indices
    sums = torch.zeros((n_seg,) + values.shape[1:], dtype=values.dtype, device=values.device)
    start = 0
    for n in host_read(torch.bincount(slot), reads).tolist():
        part = order[start:start + n]
        sums.index_add_(0, seg[part], values[part])
        start += n
    shape = (n_seg,) + (1,) * (values.dim() - 1)
    return sums / torch.clamp(counts, min=1).to(values.dtype).reshape(shape)


def triangulate_table(pts_ind, cam_ind, pts2d, n_pts, n_cam, cameras, cam_model,
                      pairs_to_triangulate, rpcs=None, lookup=None, reads=None):
    """One 3-D point per track of an observation table on a device (tensors
    sorted by point; n_cam cameras): the mean of its duos' triangulations
    (observation_duos). Returns ((n_pts, 3) float64 on the table's device,
    zeros for a track without a duo; the number of duos). cameras:
    RPCModels (cam_model "rpc"; or their stacked fields `rpcs`, on any
    device) or 3x4 matrices. lookup: pair_lookup's of the pairs, where the
    caller has it. Its reads of the device are counted in reads."""
    dev = pts_ind.device
    if lookup is None:
        lookup = pair_lookup(pairs_to_triangulate, n_cam, dev)
    with span("triangulate.duos") as duos:
        a, b = observation_duos(pts_ind, cam_ind, n_pts, n_cam, lookup, reads)
        duos.attrs["duos"] = B = int(a.numel())
    if B == 0:
        return torch.zeros((n_pts, 3), dtype=torch.float64, device=dev), 0
    if cam_model == "rpc":
        rpcs = stack_rpcs(cameras, dev) if rpcs is None else map_rpc(lambda f: f.to(dev), rpcs)
    else:
        mats = torch.as_tensor(np.stack([np.asarray(c, np.float64) for c in cameras]),
                               device=dev)
    # on the card rpc_triangulate is one launch; the plain versions go in chunks
    chunk = B if cam_model == "rpc" and dev.type == "cuda" else _plain_chunk()
    with span("triangulate.loop", duos=B, chunks=-(-B // chunk)):
        if cam_model == "rpc":
            pts3d, _ = rpc_triangulate(rpcs, cam_ind[a], cam_ind[b], pts2d[a], pts2d[b], reads)
        else:
            pts3d = torch.empty((B, 3), dtype=torch.float64, device=dev)
            for s in range(0, B, chunk):
                a_s, b_s = a[s:s + chunk], b[s:s + chunk]
                pts3d[s:s + chunk] = linear_triangulation(mats[cam_ind[a_s]], mats[cam_ind[b_s]],
                                                          pts2d[a_s], pts2d[b_s])
    with span("triangulate.mean"):
        return segment_mean(pts3d, pts_ind[a], n_pts, reads), B


def init_pts3d(C, cameras, cam_model, pairs_to_triangulate, verbose=False, device=None):
    """One 3-D point per track of C: the mean of its pairwise
    triangulations ((N, 3) numpy, zeros for tracks without a pair).
    cameras: RPCModels (cam_model "rpc") or 3x4 matrices. C's observations
    go to the device as a table (triangulate_table)."""
    dev = resolve_device(device)
    n_cam, n_pts = C.shape[0] // 2, C.shape[1]
    with span("triangulate.batch"):
        pt, cam = np.nonzero(~np.isnan(C[::2]).T)  # point-major
        pts2d = np.stack([C[2 * cam, pt], C[2 * cam + 1, pt]], axis=1)
        table = [torch.as_tensor(x, device=dev) for x in (pt, cam, pts2d)]
    pts3d, _ = triangulate_table(*table, n_pts, n_cam, cameras, cam_model, pairs_to_triangulate)
    return pts3d.cpu().numpy()
