"""Fitting a fresh RPC model to a corrected projection function.

Counterpart of `sat_bundleadjust_tpu/ba/rpcfit.py`: regularized iterative
weighted least squares over a 10x10x10 grid of 2d-3d correspondences, with
an image-margin doubling loop until the fitted model covers the full image.

`fit_rpcs_batched` fits every camera at once on `device` in float64: grid
localization, corrected projection, then the IRLS as batched (M, 39, 39)
Cholesky solves. The JAX package runs that IRLS as a `lax.while_loop`
under `vmap`, where a camera whose own test has ended keeps its state while
the others iterate; here a per-camera active mask does the same, with one
host sync per IRLS iteration. A failed factorization does not raise: its
solution is NaN, as JAX's Cholesky gives, and the camera stops iterating.
The coverage test (convex hull against the image rectangle) is host
geometry, once per margin round. `fit_Rt_corrected_rpc` and
`fit_rpc_from_projection_matrix` (the refit of a matrix camera) fit one
camera on the host.
"""

import numpy as np
import torch

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.models import ellipsoid
from sat_bundleadjust_tpu_torch.models.cameras import (
    apply_projection_matrix,
    apply_rpc_projection_np,
    generate_point_mesh,
)
from sat_bundleadjust_tpu_torch.models.rpc import (
    RPCModel,
    _np_basis,
    map_rpc,
    poly20_basis,
    rpc_localization,
    rpc_localization_np,
    rpc_projection,
    rpc_projection_np,
    stack_rpcs,
)
from sat_bundleadjust_tpu_torch.ops.project import adjust_pts3d
from sat_bundleadjust_tpu_torch.utils.polygons import Polygon, convex_hull_polygon
from sat_bundleadjust_tpu_torch.utils.profiling import span

MAX_IRLS_ITERS = 20
IRLS_TOL = 1e-2
REG_H = 1e-3


def _np_adjust_pts3d(pts3d, rt_vec):
    """Host-side correction X' = R(X - T - C) + C (numpy twin of
    ops.project.adjust_pts3d)."""
    rt_vec = np.asarray(rt_vec)
    pts = np.asarray(pts3d) - rt_vec[..., 3:6] - rt_vec[..., 6:9]
    a, b, c = rt_vec[..., 0], rt_vec[..., 1], rt_vec[..., 2]
    cx, sx = np.cos(a), np.sin(a)
    cy, sy = np.cos(b), np.sin(b)
    cz, sz = np.cos(c), np.sin(c)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    y, z = cx * y - sx * z, sx * y + cx * z
    x, z = cy * x + sy * z, -sy * x + cy * z
    x, y = cz * x - sz * y, sz * x + cz * y
    return np.stack([x, y, z], axis=-1) + rt_vec[..., 6:9]


def scaling_params(v):
    """min/max scale and offset."""
    v = np.asarray(v)
    scale = (v.max() - v.min()) / 2.0
    offset = v.min() + scale
    return scale, offset


def initialize_rpc(target, input_locs):
    """Empty RPC with scales/offsets from the data ranges."""
    zeros = np.zeros(20)
    row_scale, row_offset = scaling_params(target[:, 1])
    col_scale, col_offset = scaling_params(target[:, 0])
    lat_scale, lat_offset = scaling_params(input_locs[:, 1])
    lon_scale, lon_offset = scaling_params(input_locs[:, 0])
    alt_scale, alt_offset = scaling_params(input_locs[:, 2])
    return RPCModel(
        line_num=zeros.copy(), line_den=zeros.copy(),
        samp_num=zeros.copy(), samp_den=zeros.copy(),
        row_offset=row_offset, col_offset=col_offset,
        lat_offset=lat_offset, lon_offset=lon_offset, alt_offset=alt_offset,
        row_scale=max(row_scale, 1e-9), col_scale=max(col_scale, 1e-9),
        lat_scale=max(lat_scale, 1e-12), lon_scale=max(lon_scale, 1e-12),
        alt_scale=max(alt_scale, 1e-9),
    )


def _irls_coeffs(target_norm, locs_norm, stats=None):
    """Batched IRLS core: (M, 80) coefficients (row_num, row_den, col_num,
    col_den) from normalized correspondences target_norm (M, N, 2) and
    locs_norm (M, N, 3) (lon, lat, alt), float64 on one device.

    A direct least-squares solve, then up to MAX_IRLS_ITERS reweighted
    solves with 1/den^2 weights and the REG_H^2 regularizer; a camera stops
    when its normalized RMSE moves by less than IRLS_TOL * 1e-3. Every
    normal matrix gets a 1e-10 x mean-diagonal jitter before its Cholesky
    factorization. `stats`, if a dict, receives the iterations of each
    camera ("irls_iters") and the loop's host syncs."""
    C = target_norm[..., 0:1]
    R = target_norm[..., 1:2]
    lon, lat, alt = locs_norm[..., 0], locs_norm[..., 1], locs_norm[..., 2]
    basis = poly20_basis(lat, lon, alt)  # (M, N, 20), column 0 == 1
    pv = basis[..., 1:]
    MC = torch.cat([torch.ones_like(C), pv, -C * pv], dim=-1)  # (M, N, 39)
    MR = torch.cat([torch.ones_like(R), pv, -R * pv], dim=-1)
    eye = torch.eye(39, dtype=basis.dtype, device=basis.device)
    reg = (REG_H ** 2) * eye

    def solve(Mat, t, W=None):
        if W is None:
            A = Mat.mT @ Mat
            b = Mat.mT @ t
        else:
            MW = Mat * W[..., None]
            A = MW.mT @ Mat + reg
            b = MW.mT @ t
        jitter = 1e-10 * (torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 39)[:, None, None] * eye
        L, info = torch.linalg.cholesky_ex(A + jitter)
        y = torch.linalg.solve_triangular(L, b, upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
        # a failed factorization gives NaN, as JAX's Cholesky does
        return torch.where((info != 0)[:, None], torch.full_like(x, float("nan")), x)

    def coeffs_from(J):
        return J[:, :20], torch.cat([torch.ones_like(J[:, :1]), J[:, 20:]], dim=1)

    def apply(coeffs):
        return (basis @ coeffs[..., None])[..., 0]

    def rmse(JR, JC):
        rn, rd = coeffs_from(JR)
        cn, cd = coeffs_from(JC)
        row_pred = apply(rn) / apply(rd)
        col_pred = apply(cn) / apply(cd)
        return torch.sqrt(0.5 * (torch.mean((col_pred - C[..., 0]) ** 2, dim=1)
                                 + torch.mean((row_pred - R[..., 0]) ** 2, dim=1)))

    with span("rpcfit.irls", cameras=int(C.shape[0])) as fit:
        JR = solve(MR, R)
        JC = solve(MC, C)
        err = rmse(JR, JC)
        delta = err + 1.0
        it = torch.zeros_like(err, dtype=torch.int64)
        syncs = 0
        while True:
            active = (it < MAX_IRLS_ITERS) & (delta >= IRLS_TOL * 1e-3)
            syncs += 1
            if not bool(active.any()):
                break
            _, rd = coeffs_from(JR)
            _, cd = coeffs_from(JC)
            JR_new = solve(MR, R, 1.0 / apply(rd) ** 2)
            JC_new = solve(MC, C, 1.0 / apply(cd) ** 2)
            err_new = rmse(JR_new, JC_new)
            a = active[:, None]
            JR = torch.where(a, JR_new, JR)
            JC = torch.where(a, JC_new, JC)
            delta = torch.where(active, (err - err_new).abs(), delta)
            err = torch.where(active, err_new, err)
            it = it + active.to(it.dtype)
        fit.attrs["host_syncs"] = syncs
    if stats is not None:
        stats["irls_iters"] = it.cpu().numpy()
        stats["host_syncs"] = stats.get("host_syncs", 0) + syncs
    rn, rd = coeffs_from(JR)
    cn, cd = coeffs_from(JC)
    return torch.cat([rn, rd, cn, cd], dim=1)


def _refit_batch(rpcs, Rt_vecs, gt, cols, rows, alts, stats=None):
    """One refit round for every camera: grid localization through the
    original RPCs -> corrected-projection targets -> per-camera
    normalization -> IRLS -> fitted coefficients, fit errors and the grid
    predictions (for the coverage test).

    rpcs: batched RPCModel (leading dim M) on the device; Rt_vecs (M, 9);
    gt (3,); cols/rows/alts (M, N), all float64 tensors on one device.
    Returns coeffs (M, 80), scales (M, 10), pred (M, N, 2), err (M, N)."""
    rpc = map_rpc(lambda f: f[:, None] if f.dim() == 1 else f[:, None, :], rpcs)
    lon, lat = rpc_localization(rpc, cols, rows, alts)
    pts = ellipsoid.latlon_to_ecef_arr(lat, lon, alts) + gt
    padj = adjust_pts3d(pts, Rt_vecs[:, None, :])
    lat2, lon2, alt2 = ellipsoid.ecef_to_latlon_arr(padj)
    c2, r2 = rpc_projection(rpc, lon2, lat2, alt2)
    target = torch.stack([c2, r2], dim=-1)

    def sc(v, eps):
        vmin = v.min(dim=1).values
        s = (v.max(dim=1).values - vmin) / 2.0
        return torch.clamp(s, min=eps), vmin + s

    cs, co = sc(target[..., 0], 1e-9)
    rs, ro = sc(target[..., 1], 1e-9)
    los, loo = sc(lon, 1e-12)
    las, lao = sc(lat, 1e-12)
    als, alo = sc(alts, 1e-9)
    t_norm = torch.stack([(target[..., 0] - co[:, None]) / cs[:, None],
                          (target[..., 1] - ro[:, None]) / rs[:, None]], dim=-1)
    nlon = (lon - loo[:, None]) / los[:, None]
    nlat = (lat - lao[:, None]) / las[:, None]
    nalt = (alts - alo[:, None]) / als[:, None]
    coeffs = _irls_coeffs(t_norm, torch.stack([nlon, nlat, nalt], dim=-1), stats)

    # the fitted model on the grid: fit error and the reprojected hull
    basis = poly20_basis(nlat, nlon, nalt)

    def rfm(lo, hi):
        return (basis @ coeffs[:, lo:hi, None])[..., 0]

    row_pred = rfm(0, 20) / rfm(20, 40) * rs[:, None] + ro[:, None]
    col_pred = rfm(40, 60) / rfm(60, 80) * cs[:, None] + co[:, None]
    pred = torch.stack([col_pred, row_pred], dim=-1)
    err = torch.linalg.norm(pred - target, dim=-1)
    scales = torch.stack([co, cs, ro, rs, loo, los, lao, las, alo, als], dim=1)
    return coeffs, scales, pred, err


def fit_rpcs_batched(Rt_vecs, global_transform, original_rpcs, crop_offsets,
                     pts3d_ba_list, n_samples=10, device=None, stats=None):
    """Fit fresh RPCs for all cameras, one batched round per margin.

    Each round fits every camera on `device` (_refit_batch); a camera whose
    fitted model covers its image keeps that result, the others re-enter
    the next round with doubled margins, up to a margin above 1000 px.
    Returns a list of (rpc_calib, err, margin) per camera, as
    fit_Rt_corrected_rpc. `stats`, if a dict, receives the rounds, the host
    syncs and the IRLS iterations of the last round."""
    dev = resolve_device(device)
    M = len(original_rpcs)
    if M == 0:
        return []
    gt = np.zeros(3) if global_transform is None else np.asarray(global_transform)
    n3 = n_samples ** 3

    alt_off, alt_sc = np.zeros(M), np.zeros(M)
    for m, (rpc, pts3d_ba) in enumerate(zip(original_rpcs, pts3d_ba_list)):
        alt_off[m] = float(np.asarray(rpc.alt_offset))
        alt_sc[m] = float(np.asarray(rpc.alt_scale))
        pts_alt = np.asarray(pts3d_ba) - (np.asarray(global_transform)
                                          if global_transform is not None else 0.0)
        if len(pts_alt):
            _, _, alts_ba = ellipsoid.ecef_to_latlon_np(pts_alt[:, 0], pts_alt[:, 1],
                                                        pts_alt[:, 2])
            deviation = abs(alt_off[m] - float(np.median(alts_ba)))
            if deviation > 5:
                print("warning: median altitude of bundle adjustment points is "
                      "{:.2f} meters deviated from the original rpc alt_offset".format(deviation))

    boundaries = []
    for off in crop_offsets:
        x0, y0, w, h = off["col0"], off["row0"], off["width"], off["height"]
        boundaries.append(Polygon(np.array([[x0, y0], [x0, y0 + h], [x0 + w, y0 + h], [x0 + w, y0]])))

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    rpcs = stack_rpcs(original_rpcs, dev)
    Rt = f64(np.asarray(Rt_vecs, float).reshape(M, 9))
    gt_t = f64(gt)

    margins = np.full(M, 10, dtype=np.int64)
    done = np.zeros(M, bool)
    results = [None] * M
    rounds = 0
    while not done.all():
        cols = np.empty((M, n3))
        rows = np.empty((M, n3))
        alts = np.empty((M, n3))
        for m in range(M):
            off = crop_offsets[m]
            x0, y0, w, h = off["col0"], off["row0"], off["width"], off["height"]
            mg = margins[m]
            cols[m], rows[m], alts[m] = generate_point_mesh(
                [x0 - mg, x0 + w + mg, n_samples],
                [y0 - mg, y0 + h + mg, n_samples],
                [alt_off[m] - alt_sc[m], alt_off[m] + alt_sc[m], n_samples],
            )
        out = _refit_batch(rpcs, Rt, gt_t, f64(cols), f64(rows), f64(alts), stats)
        coeffs, scales, pred, err = (t.cpu().numpy() for t in out)
        rounds += 1
        for m in range(M):
            if done[m]:
                continue
            covered = check_correspondences_are_good(pred[m], boundaries[m])
            if covered or margins[m] > 1000:
                co, cs, ro, rs, loo, los, lao, las, alo, als = scales[m]
                rpc_calib = RPCModel(
                    line_num=coeffs[m, 0:20], line_den=coeffs[m, 20:40],
                    samp_num=coeffs[m, 40:60], samp_den=coeffs[m, 60:80],
                    row_offset=ro, col_offset=co,
                    lat_offset=lao, lon_offset=loo, alt_offset=alo,
                    row_scale=rs, col_scale=cs,
                    lat_scale=las, lon_scale=los, alt_scale=als,
                )
                results[m] = (rpc_calib, err[m], int(margins[m]))
                done[m] = True
            else:
                margins[m] *= 2
    if stats is not None:
        stats["rounds"] = rounds
        stats["host_syncs"] = stats.get("host_syncs", 0) + rounds
    return results


def _irls_coeffs_np(target_norm, locs_norm):
    """Numpy twin of _irls_coeffs for one camera (np.linalg.solve, no
    jitter, as the JAX package's numpy twin)."""
    C = target_norm[:, 0:1]
    R = target_norm[:, 1:2]
    lon, lat, alt = locs_norm[:, 0], locs_norm[:, 1], locs_norm[:, 2]
    basis = _np_basis(lat, lon, alt)
    pv = basis[:, 1:]
    MC = np.concatenate([np.ones_like(C), pv, -C * pv], axis=1)
    MR = np.concatenate([np.ones_like(R), pv, -R * pv], axis=1)
    reg = (REG_H ** 2) * np.eye(39)

    def solve(Mat, t, W=None):
        if W is None:
            A = Mat.T @ Mat
            b = Mat.T @ t
        else:
            MW = Mat * W[:, None]
            A = MW.T @ Mat + reg
            b = MW.T @ t
        return np.linalg.solve(A, b)[:, 0]

    def coeffs_from(J):
        return J[:20], np.concatenate([[1.0], J[20:]])

    def rmse(JR, JC):
        rn, rd = coeffs_from(JR)
        cn, cd = coeffs_from(JC)
        row_pred = (basis @ rn) / (basis @ rd)
        col_pred = (basis @ cn) / (basis @ cd)
        return np.sqrt(0.5 * (np.mean((col_pred - C[:, 0]) ** 2) + np.mean((row_pred - R[:, 0]) ** 2)))

    JR = solve(MR, R)
    JC = solve(MC, C)
    err = rmse(JR, JC)
    for _ in range(MAX_IRLS_ITERS):
        _, rd = coeffs_from(JR)
        _, cd = coeffs_from(JC)
        JR = solve(MR, R, 1.0 / (basis @ rd) ** 2)
        JC = solve(MC, C, 1.0 / (basis @ cd) ** 2)
        err_prev, err = err, rmse(JR, JC)
        if abs(err_prev - err) < IRLS_TOL * 1e-3:
            break
    rn, rd = coeffs_from(JR)
    cn, cd = coeffs_from(JC)
    return np.concatenate([rn, rd, cn, cd])


def weighted_lsq(target, input_locs):
    """Fit an RPC (numpy fields) from (N, 2) pixel targets and (N, 3)
    (lon, lat, alt) inputs, on the host."""
    target = np.asarray(target)
    input_locs = np.asarray(input_locs)
    rpc = initialize_rpc(target, input_locs)
    t_norm = np.stack([(target[:, 0] - rpc.col_offset) / rpc.col_scale,
                       (target[:, 1] - rpc.row_offset) / rpc.row_scale], axis=1)
    l_norm = np.stack([(input_locs[:, 0] - rpc.lon_offset) / rpc.lon_scale,
                       (input_locs[:, 1] - rpc.lat_offset) / rpc.lat_scale,
                       (input_locs[:, 2] - rpc.alt_offset) / rpc.alt_scale], axis=1)
    x = _irls_coeffs_np(t_norm, l_norm)
    return rpc._replace(line_num=x[0:20], line_den=x[20:40], samp_num=x[40:60], samp_den=x[60:80])


def check_errors(rpc_calib, input_locs, target):
    """Reprojection error of the calibrated RPC on the fit grid."""
    col, row = rpc_projection_np(rpc_calib, input_locs[:, 0], input_locs[:, 1], input_locs[:, 2])
    return np.linalg.norm(np.stack([col, row], axis=1) - np.asarray(target), axis=1)


def check_correspondences_are_good(target, image_boundary):
    """Full-image coverage: the hull of the reprojected grid must cover the
    image rectangle."""
    hull = convex_hull_polygon(np.asarray(target))
    if hull.coords.shape[0] < 3 or image_boundary.area == 0:
        return False
    inter = image_boundary.intersection(hull)
    return bool(abs(inter.area / image_boundary.area - 1.0) < 1e-9)


def _fit_loop(project_grid_fn, original_rpc, crop_offset, pts3d_ba,
              alt_offset=None, alt_scale=None, n_samples=10):
    """Margin-doubling fit loop of one camera on the host. project_grid_fn
    maps (N, 3) ECEF points to (N, 2) pixels with the corrected model."""
    pts3d_ba = np.asarray(pts3d_ba)
    if alt_offset is None:
        alt_offset = float(np.asarray(original_rpc.alt_offset))
    if alt_scale is None:
        alt_scale = float(np.asarray(original_rpc.alt_scale))
    _, _, alts_ba = ellipsoid.ecef_to_latlon_np(pts3d_ba[:, 0], pts3d_ba[:, 1], pts3d_ba[:, 2])
    deviation = abs(alt_offset - float(np.median(alts_ba)))
    if deviation > 5:
        print("warning: median altitude of bundle adjustment points is "
              "{:.2f} meters deviated from the original rpc alt_offset".format(deviation))
    min_alt, max_alt = -alt_scale + alt_offset, alt_scale + alt_offset

    x0, y0 = crop_offset["col0"], crop_offset["row0"]
    w, h = crop_offset["width"], crop_offset["height"]
    image_boundary = Polygon(np.array([[x0, y0], [x0, y0 + h], [x0 + w, y0 + h], [x0 + w, y0]]))

    margin = 10
    while True:
        cols, lins, alts = generate_point_mesh(
            [x0 - margin, x0 + w + margin, n_samples],
            [y0 - margin, y0 + h + margin, n_samples],
            [min_alt, max_alt, n_samples],
        )
        lons, lats = rpc_localization_np(original_rpc, cols, lins, alts)
        x, y, z = ellipsoid.latlon_to_ecef_np(lats, lons, alts)
        pts3d = np.stack([x, y, z], axis=1)
        target = np.asarray(project_grid_fn(pts3d))
        input_locs = np.stack([lons, lats, alts], axis=1)

        rpc_calib = weighted_lsq(target, input_locs)
        rmse_err = check_errors(rpc_calib, input_locs, target)
        covered = check_correspondences_are_good(apply_rpc_projection_np(rpc_calib, pts3d),
                                                 image_boundary)
        if margin > 1000 or covered:
            return rpc_calib, rmse_err, margin
        margin *= 2


def fit_Rt_corrected_rpc(Rt_vec, global_transform, original_rpc, crop_offset, pts3d_ba,
                         n_samples=10):
    """Fit a fresh RPC to the corrected mapping x = P(R(X - T - C) + C), one
    camera on the host."""
    Rt_vec = np.asarray(Rt_vec).reshape(1, 9)
    pts3d_ba = np.asarray(pts3d_ba)
    pts3d_adj_for_alt = pts3d_ba - global_transform if global_transform is not None else pts3d_ba

    def project_grid(pts3d):
        p = pts3d + global_transform if global_transform is not None else pts3d
        return apply_rpc_projection_np(original_rpc, _np_adjust_pts3d(p, Rt_vec))

    return _fit_loop(project_grid, original_rpc, crop_offset, pts3d_adj_for_alt,
                     n_samples=n_samples)


def fit_rpc_from_projection_matrix(P, global_transform, original_rpc, crop_offset, pts3d_ba,
                                   n_samples=10):
    """Fit a fresh RPC to a 3x4 projection matrix of the crop, one camera on
    the host; the altitude range is centred on the points' median altitude,
    at least +-8000 m wide."""
    pts3d_ba = np.asarray(pts3d_ba)
    pts3d_adj_for_alt = pts3d_ba - global_transform if global_transform is not None else pts3d_ba
    _, _, alts = ellipsoid.ecef_to_latlon_np(
        pts3d_adj_for_alt[:, 0], pts3d_adj_for_alt[:, 1], pts3d_adj_for_alt[:, 2])
    alt_offset = float(np.median(alts))
    alt_scale = max(8000.0, float(np.asarray(original_rpc.alt_scale)))
    x0, y0 = crop_offset["col0"], crop_offset["row0"]

    def project_grid(pts3d):
        p = pts3d + global_transform if global_transform is not None else pts3d
        return apply_projection_matrix(P, p) + np.array([x0, y0])

    return _fit_loop(project_grid, original_rpc, crop_offset, pts3d_adj_for_alt,
                     alt_offset=alt_offset, alt_scale=alt_scale, n_samples=n_samples)
