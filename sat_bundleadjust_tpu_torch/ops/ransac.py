"""Batched-hypothesis RANSAC for the fundamental matrix (host numpy).

Counterpart of `sat_bundleadjust_tpu/ops/ransac.py`. `ransac_fundamental_many`
is its pure-numpy batched RANSAC with the same `RandomState` stream, dtypes,
adaptive stopping and refit, so it gives the same inliers bit for bit.
`ransac_fundamental` (one pair) takes the JAX package's numpy path
(`_ransac_numpy`): the JAX path draws its minimal sets with `jax.random`,
which the port does not reproduce, so the two agree by property, not bits.

The inlier criterion is the max-of-both-images squared epipolar distance
below thr^2 (OpenCV's FM_RANSAC error)."""

import numpy as np

N_HYPOTHESES = 512
MIN_SAMPLES = 8
# hypotheses scored per tile: bounds the transient (tile, N) error matrix
HYP_TILE = 64


def _np_eight_point(pts1, pts2):
    """Normalized 8-point algorithm, batched over leading dims:
    pts (..., S, 2) -> F (..., 3, 3)."""
    def normalize(pts):
        c = pts.mean(axis=-2, keepdims=True)
        centered = pts - c
        scale = np.sqrt(2.0) / np.maximum(
            np.mean(np.linalg.norm(centered, axis=-1), axis=-1), 1e-12
        )
        T = np.zeros(pts.shape[:-2] + (3, 3))
        T[..., 0, 0] = scale
        T[..., 1, 1] = scale
        T[..., 0, 2] = -scale * c[..., 0, 0]
        T[..., 1, 2] = -scale * c[..., 0, 1]
        T[..., 2, 2] = 1.0
        return centered * scale[..., None, None], T

    n1, T1 = normalize(pts1)
    n2, T2 = normalize(pts2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    A = np.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, np.ones_like(x1)], axis=-1
    )
    # economy SVD unless the null vector needs the full Vh (S <= 9): a full
    # SVD of a large-S refit would materialize an S x S U block
    _, _, vh = np.linalg.svd(A, full_matrices=A.shape[-2] <= A.shape[-1])
    F = vh[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    u, s, vt = np.linalg.svd(F)
    s[..., 2] = 0.0
    F = u @ (s[..., None] * vt)
    F = np.swapaxes(T2, -1, -2) @ F @ T1
    norm = np.linalg.norm(F.reshape(F.shape[:-2] + (9,)), axis=-1)
    return F / np.maximum(norm, 1e-30)[..., None, None]


def _np_sym_err(F, pts1, pts2):
    """Max-of-both squared epipolar distance: F (..., 3, 3), pts (N, 2)."""
    h1 = np.concatenate([pts1, np.ones_like(pts1[..., :1])], axis=-1)
    h2 = np.concatenate([pts2, np.ones_like(pts2[..., :1])], axis=-1)
    l2 = h1 @ np.swapaxes(F, -1, -2)
    l1 = h2 @ F
    num = np.sum(l2 * h2, axis=-1)
    d2 = num ** 2 / np.maximum(l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-30)
    d1 = num ** 2 / np.maximum(l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-30)
    return np.maximum(d1, d2)


def ransac_fundamental_many(pts1_list, pts2_list, thr=0.3, seed=0,
                            n_hypotheses=N_HYPOTHESES, refit=True,
                            adaptive=True, confidence=0.99):
    """RANSAC batched across pairs, with the standard adaptive stopping rule:
    hypotheses are scored in blocks of 32, and a pair stops once
    (1 - (1 - w^8)^k) >= confidence at its best inlier ratio w so far
    (capped at n_hypotheses). With adaptive=False the per-pair inliers are
    those of `_ransac_numpy`.

    Returns a list of (F (3, 3) or None, inlier mask (N_b,) or None)."""
    B = len(pts1_list)
    if B == 0:
        return []
    pts1 = [np.asarray(p, np.float64) for p in pts1_list]
    pts2 = [np.asarray(p, np.float64) for p in pts2_list]
    valid = [np.isfinite(p1[:, 0]) & np.isfinite(p2[:, 0])
             for p1, p2 in zip(pts1, pts2)]
    pools = [np.where(v)[0] for v in valid]
    results = [(None, None)] * B

    H = n_hypotheses
    block = min(32 if adaptive else H, H)
    thr2 = thr ** 2
    log1mconf = np.log(max(1.0 - confidence, 1e-12))

    rngs = {}
    for b in range(B):
        if len(pools[b]) >= MIN_SAMPLES:
            rngs[b] = np.random.RandomState(seed)

    active = sorted(rngs)
    best_count = np.zeros(B, np.int64)
    best_F = [None] * B
    done_h = np.zeros(B, np.int64)

    while active:
        # this block's minimal sets, from each pair's own stream (randint
        # fills row-major, so consecutive blocks reproduce one (H, 8) draw)
        samp = np.stack([
            pools[b][rngs[b].randint(0, len(pools[b]), size=(block, MIN_SAMPLES))]
            for b in active
        ])
        p1s = np.stack([pts1[b][samp[k]] for k, b in enumerate(active)])
        p2s = np.stack([pts2[b][samp[k]] for k, b in enumerate(active)])
        F_blk = _np_eight_point(p1s.astype(np.float32), p2s.astype(np.float32))

        next_active = []
        for k, b in enumerate(active):
            errs = _np_sym_err(F_blk[k], pts1[b], pts2[b])
            counts = ((errs < thr2) & valid[b][None, :]).sum(axis=-1)
            i = int(np.argmax(counts))
            if counts[i] > best_count[b]:
                best_count[b] = counts[i]
                best_F[b] = F_blk[k, i]
            done_h[b] += block
            if done_h[b] >= H:
                continue
            w = best_count[b] / max(len(pools[b]), 1)
            denom = np.log1p(-min(w, 1.0 - 1e-12) ** MIN_SAMPLES)
            needed = H if denom >= 0 else log1mconf / denom
            if done_h[b] < needed:
                next_active.append(b)
        active = next_active

    for b in rngs:
        if best_count[b] < MIN_SAMPLES:
            continue
        F_b = best_F[b].astype(np.float64)
        inl = (_np_sym_err(F_b, pts1[b], pts2[b]) < thr2) & valid[b]
        if refit and inl.sum() >= MIN_SAMPLES:
            F_b = _np_eight_point(
                pts1[b][inl].astype(np.float32), pts2[b][inl].astype(np.float32)
            )
            inl = (_np_sym_err(F_b, pts1[b], pts2[b]) < thr2) & valid[b]
        results[b] = (np.asarray(F_b, np.float64), inl)
    return results


def _ransac_numpy(pts1, pts2, valid, thr, seed, n_hypotheses, refit):
    """Fixed-count numpy RANSAC: n_hypotheses minimal sets from one
    RandomState(seed) draw, best count, refit on its inliers."""
    rng = np.random.RandomState(seed)
    idx_pool = np.where(valid)[0]
    if len(idx_pool) < MIN_SAMPLES:
        return None, None
    samples = idx_pool[rng.randint(0, len(idx_pool), size=(n_hypotheses, MIN_SAMPLES))]
    F = _np_eight_point(pts1[samples].astype(np.float32), pts2[samples].astype(np.float32))
    counts = np.empty(n_hypotheses, dtype=np.int64)
    for s in range(0, n_hypotheses, HYP_TILE):
        errs = _np_sym_err(F[s: s + HYP_TILE], pts1, pts2)
        counts[s: s + HYP_TILE] = ((errs < thr ** 2) & valid[None, :]).sum(axis=-1)
    best = int(np.argmax(counts))
    if counts[best] < MIN_SAMPLES:
        return None, None
    F_best = F[best]
    inliers = (_np_sym_err(F_best, pts1, pts2) < thr ** 2) & valid
    if refit:
        F_best = _np_eight_point(pts1[inliers].astype(np.float32), pts2[inliers].astype(np.float32))
        errs = _np_sym_err(F_best, pts1, pts2)
        inliers = (errs < thr ** 2) & valid
    return np.asarray(F_best, dtype=np.float64), inliers


def ransac_fundamental(pts1, pts2, thr=0.3, seed=0, n_hypotheses=N_HYPOTHESES,
                       refit=True):
    """RANSAC fundamental matrix from Nx2 matched points.

    Returns (F (3, 3), inlier mask (N,) bool) or (None, None)."""
    pts1 = np.asarray(pts1, dtype=np.float64)
    pts2 = np.asarray(pts2, dtype=np.float64)
    if pts1.shape[0] < MIN_SAMPLES:
        return None, None
    valid = np.isfinite(pts1[:, 0]) & np.isfinite(pts2[:, 0])
    return _ransac_numpy(pts1, pts2, valid, thr, seed, n_hypotheses, refit)
