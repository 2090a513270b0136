"""Pairwise descriptor matching: 2-NN with a ratio or absolute test, an
epipolar gate, and RANSAC.

Counterpart of `sat_bundleadjust_tpu/ops/match.py`, with its dispatch:
* on the card (`cuda`) the 2-NN runs in the kernels of `ops/nn2_match.py`
  with the one-sided gate |l_i . h_j|^2 <= thr^2 (l0^2 + l1^2): frames
  staged once as int8 and pair operands gathered on the device
  (`match_pairs_2nn_staged`), the host-packed batch
  (`match_pairs_2nn_batched`) or one pair (`match_pair`) — as the JAX
  package does on a TPU;
* on the CPU, `match_descriptors_2nn`, the JAX package's CPU matcher, whose
  gate is the symmetric epipolar distance. The two gates give different
  match sets; each device's path is compared with the JAX package's path
  for the same backend.
"""

import numpy as np
import torch

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.ops import nn2_match
from sat_bundleadjust_tpu_torch.utils.profiling import span

EPIPOLAR_THR = 20.0  # px
BIG = 1e12


def _epipolar_distance_sq(pts_i, pts_j, F):
    """Max of the squared distances of pts_j to the lines F h_i and of pts_i
    to the lines F^T h_j: pts_i (B, 2), pts_j (N2, 2), F (3, 3) -> (B, N2)."""
    hi = torch.cat([pts_i, torch.ones_like(pts_i[:, :1])], dim=-1)
    hj = torch.cat([pts_j, torch.ones_like(pts_j[:, :1])], dim=-1)
    li = hi @ F.T
    lj = hj @ F
    num = li @ hj.T
    d_j = num ** 2 / torch.clamp_min(li[:, 0:1] ** 2 + li[:, 1:2] ** 2, 1e-30)
    d_i = num ** 2 / torch.clamp_min((lj[:, 0] ** 2 + lj[:, 1] ** 2)[None, :], 1e-30)
    return torch.maximum(d_i, d_j)


def match_descriptors_2nn(desc_i, desc_j, pts_i, pts_j, valid_i, valid_j, F=None,
                          rel_thr=0.6, abs_thr=250.0, epipolar_thr=EPIPOLAR_THR,
                          method="relative", block=2048):
    """2-NN matching with a ratio ("relative": d1 < rel_thr^2 d2) or
    absolute (d1 < abs_thr^2) test and an optional symmetric epipolar gate.

    Tensors on one device: desc_* (N, 128), pts_* (N, 2), valid_* (N,) bool,
    F (3, 3) or None. Returns (nn_idx (N1,) int64, accepted (N1,) bool,
    d1 (N1,) f32)."""
    big = torch.tensor(BIG, dtype=torch.float32, device=desc_i.device)
    desc_j_t = torch.where(valid_j[:, None], desc_j, torch.zeros_like(desc_j)).to(torch.float32)
    sq_j = torch.sum(desc_j_t * desc_j_t, dim=-1)
    desc_i_t = torch.where(valid_i[:, None], desc_i, torch.zeros_like(desc_i)).to(torch.float32)
    pts_i_t = pts_i.to(torch.float32)
    pts_j_t = pts_j.to(torch.float32)
    F_t = None if F is None else F.to(torch.float32)
    cols = torch.arange(desc_j.shape[0], device=desc_i.device)
    out_idx, out_ok, out_d1 = [], [], []
    for r0 in range(0, desc_i.shape[0], block):
        di = desc_i_t[r0: r0 + block]
        vi = valid_i[r0: r0 + block]
        sq_i = torch.sum(di * di, dim=-1)
        cross = di @ desc_j_t.T
        d2 = torch.clamp_min(sq_i[:, None] + sq_j[None, :] - 2.0 * cross, 0.0)
        mask = valid_j[None, :] & vi[:, None]
        if F_t is not None:
            ed = _epipolar_distance_sq(pts_i_t[r0: r0 + block], pts_j_t, F_t)
            mask = mask & (ed < epipolar_thr ** 2)
        d2 = torch.where(mask, d2, big)
        idx1 = torch.argmin(d2, dim=1)
        d1 = torch.gather(d2, 1, idx1[:, None])[:, 0]
        dsecond = torch.where(cols[None, :] == idx1[:, None], big, d2).min(dim=1).values
        if method == "relative":
            ok = d1 < (rel_thr ** 2) * dsecond
        else:
            ok = d1 < abs_thr ** 2
        ok = ok & (d1 < big * 0.5) & vi
        out_idx.append(idx1)
        out_ok.append(ok)
        out_d1.append(d1)
    if not out_idx:
        empty = torch.zeros(0, device=desc_i.device)
        return empty.long(), empty.bool(), empty.float()
    return torch.cat(out_idx), torch.cat(out_ok), torch.cat(out_d1)


def _accept(d1, d2, method, rel_thr, abs_thr):
    if method == "relative":
        return d1 < (rel_thr ** 2) * d2
    return d1 < abs_thr ** 2


def match_pair(features_i, features_j, F=None, rel_thr=0.6, abs_thr=250.0,
               method="relative", ransac_thr=0.3, epipolar_thr=EPIPOLAR_THR, device=None):
    """2-NN + ratio test (+ epipolar gate), then RANSAC, for one pair of
    (N, 132) keypoint arrays (col, row, scale, orientation, descriptor;
    NaN rows are padding). On the card: the single-pair kernel; on the
    CPU: match_descriptors_2nn.

    Returns (matches_ij (M, 2) int64 or None, n_ratio, n_ransac)."""
    dev = resolve_device(device)
    features_i = np.asarray(features_i)
    features_j = np.asarray(features_j)
    valid_i = ~np.isnan(features_i[:, 0])
    valid_j = ~np.isnan(features_j[:, 0])
    if valid_i.sum() == 0 or valid_j.sum() == 0:
        return None, 0, 0

    if dev.type == "cuda":
        d1, d2, nn = nn2_match.nn2_single(
            *single_pair_operands(features_i, features_j, F, epipolar_thr, dev))
        d1, d2, nn_idx = d1.cpu().numpy(), d2.cpu().numpy(), nn.cpu().numpy()
        accepted = _accept(d1, d2, method, rel_thr, abs_thr) & (d1 < 5e11) & valid_i
        return _finalize_matches(features_i, features_j, nn_idx, accepted, ransac_thr)

    nn_idx, accepted, _ = match_descriptors_2nn(
        *[torch.as_tensor(a, device=dev) for a in (
            np.nan_to_num(features_i[:, 4:]), np.nan_to_num(features_j[:, 4:]),
            np.nan_to_num(features_i[:, :2]), np.nan_to_num(features_j[:, :2]),
            valid_i, valid_j)],
        F=None if F is None else torch.as_tensor(np.asarray(F), device=dev),
        rel_thr=rel_thr, abs_thr=abs_thr, epipolar_thr=epipolar_thr, method=method,
    )
    return _finalize_matches(features_i, features_j, nn_idx.cpu().numpy(),
                             accepted.cpu().numpy(), ransac_thr)


def single_pair_operands(features_i, features_j, F, epipolar_thr, device):
    """nn2_single's operands for one pair of (N, 132) keypoint arrays (NaN
    rows are padding): descriptors, the epipolar lines F h_i of the rows,
    the homogeneous points of the columns, validity masks (float32 tensors
    on device) and the scalar threshold (1e9, no gate, without F)."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    features_i, features_j = np.asarray(features_i), np.asarray(features_j)
    pts_j = np.nan_to_num(features_j[:, :2])
    hp_j = np.hstack([pts_j, np.ones((len(pts_j), 1))])
    if F is not None:
        h_i = np.hstack([np.nan_to_num(features_i[:, :2]), np.ones((len(features_i), 1))])
        lines_i = h_i @ np.asarray(F).T
        thr = float(epipolar_thr)
    else:
        lines_i = np.tile(np.array([[1.0, 0.0, 0.0]]), (len(features_i), 1))
        thr = 1e9
    return (t(np.nan_to_num(features_i[:, 4:])), t(np.nan_to_num(features_j[:, 4:])),
            t(lines_i), t(hp_j), t(~np.isnan(features_i[:, 0])), t(~np.isnan(features_j[:, 0])),
            thr)


def pack_pairs(pair_feats, pair_F, epipolar_thr=EPIPOLAR_THR, n1=None, n2=None, b_pad=None):
    """Pack stereo pairs into the batched kernels' operand layout:
    descriptors, per-row epipolar lines l_i = F h_i, per-column homogeneous
    points, validity masks and per-pair thresholds (1e9 disables the gate),
    padded to shared (n1, n2) row counts (multiples of 256 and 512) and to
    b_pad pairs (default: the pairs given; padding pairs have no valid
    row)."""
    B = len(pair_feats) if b_pad is None else b_pad
    if n1 is None:
        n1 = max(max(np.asarray(f[0]).shape[0] for f in pair_feats), 1)
        n1 = -(-n1 // 256) * 256
    if n2 is None:
        n2 = max(max(np.asarray(f[1]).shape[0] for f in pair_feats), 1)
        n2 = -(-n2 // 512) * 512
    di = np.zeros((B, n1, 128), np.float32)
    dj = np.zeros((B, n2, 128), np.float32)
    li = np.zeros((B, n1, 3), np.float32)
    li[:, :, 0] = 1.0
    hj = np.zeros((B, n2, 3), np.float32)
    hj[:, :, 2] = 1.0
    vi = np.zeros((B, n1), np.float32)
    vj = np.zeros((B, n2), np.float32)
    thr = np.full(B, 1e9, np.float32)
    for b, ((fi, fj), F) in enumerate(zip(pair_feats, pair_F)):
        fi, fj = np.asarray(fi), np.asarray(fj)
        ki, kj = fi.shape[0], fj.shape[0]
        vi[b, :ki] = ~np.isnan(fi[:, 0])
        vj[b, :kj] = ~np.isnan(fj[:, 0])
        di[b, :ki] = np.nan_to_num(fi[:, 4:])
        dj[b, :kj] = np.nan_to_num(fj[:, 4:])
        hj[b, :kj, :2] = np.nan_to_num(fj[:, :2])
        if F is not None:
            h_i = np.hstack([np.nan_to_num(fi[:, :2]), np.ones((ki, 1))])
            li[b, :ki] = (h_i @ np.asarray(F).T).astype(np.float32)
            thr[b] = float(epipolar_thr)
    return {"di": di, "dj": dj, "li": li, "hj": hj, "vi": vi, "vj": vj, "thr": thr}


def _is_uint8_valued(d):
    return (d.min(initial=0.0) >= 0.0 and d.max(initial=0.0) <= 255.0
            and np.array_equal(d, np.rint(d)))


def int8_packable(di, dj):
    """True when the descriptors are exact integers in 0..255 (the SIFT
    quantization), so the int8 kernel is bit-identical to the f32 one."""
    return _is_uint8_valued(di) and _is_uint8_valued(dj)


def accept_from_packed(packed, pair_feats, vi, method, rel_thr, abs_thr):
    """Ratio/absolute test per pair on the packed (B, 3, n1) (d1, d2, nn)."""
    out = []
    for b, (fi, _fj) in enumerate(pair_feats):
        ki = np.asarray(fi).shape[0]
        d1, d2, nn = packed[b, 0, :ki], packed[b, 1, :ki], packed[b, 2, :ki]
        accepted = _accept(d1, d2, method, rel_thr, abs_thr) & (d1 < 5e11) & (vi[b, :ki] > 0)
        out.append((nn.astype(np.int64), accepted))
    return out


def stage_frames_for_matching(frames, device=None, counts=None):
    """Stage each frame's keypoints on the device once, for
    match_pairs_2nn_staged. frames: list of (N, 132) arrays (NaN rows
    allowed).

    Each frame's rows up to its last keypoint (the last row whose column 0
    is not NaN) go to the device in one copy, in the frame's dtype; the
    device replaces NaN by 0, tests the descriptors and packs the tables.
    The rows past a frame's last keypoint are padding (descriptor -128,
    point (0, 0, 1)); n_f leaves at least one below it in every frame that
    has such rows, so that staged_chunk_operands can send every index past
    the table to row n_f - 1. The device is read once a call (the integer
    test of all the frames).

    Returns None when a frame's descriptors are not exact integers in 0..255
    (the caller then packs f32 pairs on the host); else a dict with desc
    (n_frames, n_f, 128) int8 (descriptor - 128), hpts (n_frames, n_f, 3)
    f32 homogeneous points, and n_f (rows, a multiple of 512). counts, if
    given (a span's attributes), receives rows_given, rows_staged,
    h2d_bytes and route ("device" or "declined")."""
    dev = resolve_device(device)
    n_frames = len(frames)
    if n_frames == 0:
        return None
    frames = [np.asarray(f) for f in frames]
    rows = []
    for f in frames:
        keyed = np.flatnonzero(~np.isnan(f[:, 0]))
        rows.append(int(keyed[-1]) + 1 if len(keyed) else 0)
    n_f = max(max(k + (k < f.shape[0]) for k, f in zip(rows, frames)), 1)
    n_f = -(-n_f // 512) * 512
    desc = torch.full((n_frames, n_f, 128), -128, dtype=torch.int8, device=dev)
    hpts = torch.zeros((n_frames, n_f, 3), dtype=torch.float32, device=dev)
    hpts[:, :, 2] = 1.0
    uint8_valued = torch.ones((), dtype=torch.bool, device=dev)
    h2d_bytes = 0
    for fidx, (f, k) in enumerate(zip(frames, rows)):
        if k == 0:
            continue
        head = np.ascontiguousarray(f[:k])
        h2d_bytes += head.nbytes
        # from pageable memory the copy has left the host buffer when the call
        # returns: non_blocking only spares a synchronisation a frame
        head = torch.from_numpy(head).to(dev, non_blocking=True)
        d = torch.nan_to_num(head[:, 4:])
        uint8_valued &= ((d >= 0) & (d <= 255) & (d == torch.round(d))).all()
        desc[fidx, :k] = d - 128.0
        hpts[fidx, :k, :2] = torch.nan_to_num(head[:, :2])
    packed = bool(uint8_valued)
    if counts is not None:
        counts.update(rows_given=sum(f.shape[0] for f in frames), rows_staged=sum(rows),
                      h2d_bytes=h2d_bytes, route="device" if packed else "declined")
    if not packed:
        return None
    return {"desc": desc, "hpts": hpts, "n_f": n_f}


def staged_chunk_arrays(chunk, n1, n2, pair_frames, pair_idx, pair_F, epipolar_thr):
    """Host index arrays of one chunk of pairs: frame ids, row indices into
    the staged tables (0 on padding), validity, F (identity where the gate
    is off) and per-pair thresholds (1e9 turns the gate off)."""
    Bc = len(chunk)
    fi_a = np.zeros(Bc, np.int64)
    fj_a = np.zeros(Bc, np.int64)
    ii = np.zeros((Bc, n1), np.int64)
    jj = np.zeros((Bc, n2), np.int64)
    mi = np.zeros((Bc, n1), np.float32)
    mj = np.zeros((Bc, n2), np.float32)
    Fm = np.broadcast_to(np.eye(3, dtype=np.float32), (Bc, 3, 3)).copy()
    thr = np.full(Bc, 1e9, np.float32)
    for b, q in enumerate(chunk):
        pi, pj = pair_idx[q]
        fi_a[b], fj_a[b] = pair_frames[q]
        ii[b, : len(pi)] = pi
        jj[b, : len(pj)] = pj
        mi[b, : len(pi)] = 1.0
        mj[b, : len(pj)] = 1.0
        if pair_F[q] is not None:
            Fm[b] = np.asarray(pair_F[q], np.float32)
            thr[b] = float(epipolar_thr)
    return fi_a, ii, mi, fj_a, jj, mj, Fm, thr


def staged_chunk_operands(staged, arrays):
    """The int8 kernel's operands of one chunk, assembled on the device:
    gathers from the staged frame tables, and the lines l_i = F h_i of each
    pair. arrays: staged_chunk_arrays output. Returns (di, dj, li, hj, mi, mj,
    thr) in the nn2_batched_i8 layout."""
    dev = staged["desc"].device
    frame_i, ii, mi, frame_j, jj, mj, Fmat, thr = [torch.as_tensor(a, device=dev) for a in arrays]
    # an index past a frame's staged rows reads its padding row n_f - 1
    ii, jj = torch.clamp(ii, max=staged["n_f"] - 1), torch.clamp(jj, max=staged["n_f"] - 1)
    di = staged["desc"][frame_i[:, None], ii]  # (B, n1, 128) int8
    dj = staged["desc"][frame_j[:, None], jj]  # (B, n2, 128)
    hi = staged["hpts"][frame_i[:, None], ii]  # (B, n1, 3)
    hj = staged["hpts"][frame_j[:, None], jj].contiguous()  # (B, n2, 3)
    li = torch.bmm(hi, Fmat.transpose(1, 2)).contiguous()
    return di, dj, li, hj, mi, mj, thr


def _chunks(sizes_i, sizes_j, max_bytes):
    """Greedy chunks of the size-sorted pair list under an operand-byte
    budget (each pair padded to the chunk's largest n1 and n2)."""
    B = len(sizes_i)
    order = np.argsort([max(s, 1) for s in sizes_i], kind="stable")
    pad = lambda n, m: -(-max(n, 1) // m) * m  # noqa: E731
    c0 = 0
    while c0 < B:
        chunk = [order[c0]]
        c1 = c0 + 1
        while c1 < B:
            trial = chunk + [order[c1]]
            n1 = pad(max(sizes_i[q] for q in trial), 256)
            n2 = pad(max(sizes_j[q] for q in trial), 512)
            if len(trial) * (n1 + n2) * 131 * 4 > max_bytes:
                break
            chunk = trial
            c1 += 1
        c0 = c1
        yield chunk, pad(max(sizes_i[q] for q in chunk), 256), pad(max(sizes_j[q] for q in chunk), 512)


def staged_chunks(pair_idx, max_bytes=1 << 30):
    """The chunks (pair positions, n1, n2) in which match_pairs_2nn_staged
    sends the pairs with row subsets pair_idx to the kernel."""
    return _chunks([len(p[0]) for p in pair_idx], [len(p[1]) for p in pair_idx], max_bytes)


def match_pairs_2nn_staged(staged, pair_frames, pair_idx, pair_F, rel_thr=0.6,
                           abs_thr=250.0, method="relative", epipolar_thr=EPIPOLAR_THR,
                           max_bytes=1 << 30, timing=None):
    """2-NN + ratio stage for many pairs against staged frames.

    staged: stage_frames_for_matching output; pair_frames: list of (frame_i,
    frame_j); pair_idx: list of (idx_i, idx_j) row subsets; pair_F: per-pair
    (3, 3) F or None. Returns a list of (nn_idx, accepted) numpy arrays.
    Pairs are chunked under an operand-byte budget; every chunk is enqueued
    before the first result is read. `timing` (a dict), if given, receives
    nn_enqueue_s (index arrays, device gathers, launches) and nn_drain_s
    (waiting for the kernels, copying the results back, ratio test)."""
    B = len(pair_frames)
    if B == 0:
        return []
    results = [None] * B
    pending = []
    with span("nn2.enqueue", timing, "nn_enqueue_s"):
        for chunk, n1, n2 in staged_chunks(pair_idx, max_bytes):
            arrays = staged_chunk_arrays(chunk, n1, n2, pair_frames, pair_idx, pair_F,
                                         epipolar_thr)
            packed = nn2_match.nn2_batched_i8(*staged_chunk_operands(staged, arrays))
            pending.append((chunk, packed, arrays[2]))
    with span("nn2.drain", timing, "nn_drain_s", chunks=len(pending)):
        for chunk, packed, mi in pending:
            packed = packed.cpu().numpy()
            for b, q in enumerate(chunk):
                ki = len(pair_idx[q][0])
                d1, d2, nn = packed[b, 0, :ki], packed[b, 1, :ki], packed[b, 2, :ki]
                accepted = (_accept(d1, d2, method, rel_thr, abs_thr) & (d1 < 5e11)
                            & (mi[b, :ki] > 0))
                results[q] = (nn.astype(np.int64), accepted)
    return results


def match_pairs_2nn_batched(pair_feats, pair_F, rel_thr=0.6, abs_thr=250.0,
                            method="relative", epipolar_thr=EPIPOLAR_THR, device=None,
                            max_bytes=1 << 30):
    """2-NN + ratio/epipolar stage for many pairs of (N, 132) arrays.
    Returns a list of (nn_idx, accepted) numpy arrays.

    On the card: host-packed chunks through the batched int8 kernel (the
    f32 kernel when the descriptors are not integers in 0..255). On the
    CPU: match_descriptors_2nn per pair."""
    dev = resolve_device(device)
    B = len(pair_feats)
    if B == 0:
        return []
    if dev.type != "cuda":
        out = []
        for (fi, fj), F in zip(pair_feats, pair_F):
            fi, fj = np.asarray(fi), np.asarray(fj)
            nn, acc, _ = match_descriptors_2nn(
                *[torch.as_tensor(a, device=dev) for a in (
                    np.nan_to_num(fi[:, 4:]), np.nan_to_num(fj[:, 4:]),
                    np.nan_to_num(fi[:, :2]), np.nan_to_num(fj[:, :2]),
                    ~np.isnan(fi[:, 0]), ~np.isnan(fj[:, 0]))],
                F=None if F is None else torch.as_tensor(np.asarray(F), device=dev),
                rel_thr=rel_thr, abs_thr=abs_thr, epipolar_thr=epipolar_thr, method=method,
            )
            out.append((nn.cpu().numpy(), acc.cpu().numpy()))
        return out

    results = [None] * B
    pending = []
    for chunk, n1, n2 in _chunks([np.asarray(f[0]).shape[0] for f in pair_feats],
                                 [np.asarray(f[1]).shape[0] for f in pair_feats], max_bytes):
        feats = [pair_feats[q] for q in chunk]
        p = pack_pairs(feats, [pair_F[q] for q in chunk], epipolar_thr, n1=n1, n2=n2)
        ops = [torch.as_tensor(p[k], device=dev) for k in ("li", "hj", "vi", "vj", "thr")]
        if int8_packable(p["di"], p["dj"]):
            packed = nn2_match.nn2_batched_i8(
                torch.as_tensor((p["di"] - 128.0).astype(np.int8), device=dev),
                torch.as_tensor((p["dj"] - 128.0).astype(np.int8), device=dev), *ops)
        else:
            packed = nn2_match.nn2_batched(
                torch.as_tensor(p["di"], device=dev), torch.as_tensor(p["dj"], device=dev), *ops)
        pending.append((chunk, packed, p["vi"], feats))
    for chunk, packed, vi, feats in pending:
        for q, res in zip(chunk, accept_from_packed(packed.cpu().numpy(), feats, vi, method,
                                                    rel_thr, abs_thr)):
            results[q] = res
    return results


def _finalize_matches(features_i, features_j, nn_idx, accepted, ransac_thr):
    """Accepted pairs, then RANSAC geometric filtering."""
    from sat_bundleadjust_tpu_torch.ops.ransac import ransac_fundamental

    idx_i = np.where(accepted)[0]
    matches_ij = np.stack([idx_i, nn_idx[idx_i]], axis=1).astype(np.int64)
    n_ratio = matches_ij.shape[0]
    if n_ratio == 0:
        return None, 0, 0
    if ransac_thr is not None and n_ratio >= 8:
        pts_i = features_i[matches_ij[:, 0], :2]
        pts_j = features_j[matches_ij[:, 1], :2]
        _, inliers = ransac_fundamental(pts_i, pts_j, thr=ransac_thr)
        if inliers is None or inliers.sum() == 0:
            return None, n_ratio, 0
        matches_ij = matches_ij[inliers]
    return matches_ij, n_ratio, matches_ij.shape[0]
