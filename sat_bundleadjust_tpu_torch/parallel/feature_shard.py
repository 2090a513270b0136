"""Feature stages (detection, pairwise 2-NN matching) over the ranks of a
mesh.

Counterpart of `sat_bundleadjust_tpu/parallel/feature_shard.py`: the
per-image and per-pair work is batched along a leading axis, padded to a
multiple of the mesh's size, and each rank takes its own slice of the
axis (detection of its images, the 2-NN of its pairs, with the port's
kernels on its device); one all-gather assembles the whole axis. Every rank
calls these functions on the same inputs and returns the same results,
which equal the one-device ones.
"""

import numpy as np
import torch
import torch.distributed as dist

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.parallel.mesh import get_default_mesh, make_mesh, world_size


def default_mesh_or_none():
    """The default mesh, or a mesh over the world's ranks; None when it has
    one rank (one device: batching alone fills it, sharding would only
    pad)."""
    override = get_default_mesh()
    if override is not None:
        return override if override.size > 1 else None
    if world_size() < 2:
        return None
    return make_mesh()


def _all_gather_rows(local, mesh):
    """The (size * n, ...) concatenation of every rank's (n, ...) tensor, in
    rank order (list-form all_gather, which gloo also takes on CUDA)."""
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    return torch.cat(parts)


def _resolve_mesh(mesh):
    # None = the default (default_mesh_or_none); False = one device
    mesh = mesh if mesh is not None else default_mesh_or_none()
    return mesh or None


def match_pairs_mesh(pair_feats, pair_F, tracks_config, mesh=None, max_bytes=512 << 20,
                     device=None):
    """2-NN + ratio/epipolar stage for many pairs, the pair axis split over
    the mesh's ranks.

    pair_feats: list of (features_i, features_j) arrays in the (N, 132)
    keypoint layout; pair_F: list of (3, 3) fundamental matrices or None.
    Returns a list of (nn_idx, accepted) numpy arrays per pair. Without a
    mesh (one rank, or mesh=False): ops/match.match_pairs_2nn_batched on
    `device` (default: the card).

    Pairs are sorted by size and packed into the largest chunks that fit
    the operand-byte budget, padded to a multiple of the mesh's size; each
    rank runs the batched kernel on its slice of every chunk
    (`nn2_batched_i8` where the descriptors are integers in 0..255 on the
    card, else `nn2_batched`; on CPU tensors both are the plain nn2
    version), and one all-gather per chunk assembles (B_pad, 3, N1)."""
    from sat_bundleadjust_tpu_torch.ops import match as match_ops
    from sat_bundleadjust_tpu_torch.ops import nn2_match

    mesh = _resolve_mesh(mesh)
    n_pairs = len(pair_feats)
    if n_pairs == 0:
        return []
    method_cfg = tracks_config["FT_sift_matching"]
    method = "absolute" if method_cfg == "absolute" else "relative"
    rel_thr = float(tracks_config["FT_rel_thr"])
    abs_thr = float(tracks_config["FT_abs_thr"])
    if mesh is None:
        return match_ops.match_pairs_2nn_batched(
            pair_feats, pair_F, rel_thr=rel_thr, abs_thr=abs_thr, method=method,
            device=resolve_device(device))

    n_dev = mesh.size
    dev = mesh.device
    sizes = [max(np.asarray(fi).shape[0], 1) for fi, _ in pair_feats]
    order = np.argsort(sizes, kind="stable")
    results = [None] * n_pairs
    pending = []

    def padded(chunk):
        Ki = -(-max(max(pair_feats[q][0].shape[0] for q in chunk), 1) // 256) * 256
        Kj = -(-max(max(pair_feats[q][1].shape[0] for q in chunk), 1) // 512) * 512
        return Ki, Kj, -(-len(chunk) // n_dev) * n_dev

    # greedy chunking under the operand-byte budget (the JAX package's)
    c0 = 0
    while c0 < n_pairs:
        chunk = [order[c0]]
        c1 = c0 + 1
        while c1 < n_pairs:
            trial = chunk + [order[c1]]
            Ki, Kj, B_pad = padded(trial)
            if B_pad * (Ki + Kj) * 131 * 4 > max_bytes and len(chunk) >= n_dev:
                break
            chunk = trial
            c1 += 1
        c0 = c1

        Ki, Kj, B_pad = padded(chunk)
        p = match_ops.pack_pairs([pair_feats[q] for q in chunk], [pair_F[q] for q in chunk],
                                 match_ops.EPIPOLAR_THR, n1=Ki, n2=Kj, b_pad=B_pad)
        per = B_pad // n_dev
        mine = slice(mesh.index * per, (mesh.index + 1) * per)
        ops = [torch.as_tensor(p[k][mine], device=dev) for k in ("li", "hj", "vi", "vj", "thr")]
        if dev.type == "cuda" and match_ops.int8_packable(p["di"], p["dj"]):
            local = nn2_match.nn2_batched_i8(
                torch.as_tensor((p["di"][mine] - 128.0).astype(np.int8), device=dev),
                torch.as_tensor((p["dj"][mine] - 128.0).astype(np.int8), device=dev), *ops)
        else:
            local = nn2_match.nn2_batched(torch.as_tensor(p["di"][mine], device=dev),
                                          torch.as_tensor(p["dj"][mine], device=dev), *ops)
        pending.append((chunk, _all_gather_rows(local, mesh), p["vi"]))

    for chunk, packed, vi in pending:
        feats = [pair_feats[q] for q in chunk]
        for q, res in zip(chunk, match_ops.accept_from_packed(packed.cpu().numpy(), feats, vi,
                                                              method, rel_thr, abs_thr)):
            results[q] = res
    return results


def detect_batches_mesh(images, tracks_config, mesh=None, max_kp=None, device=None):
    """SIFT detection of same-shape images, the image axis split over the
    mesh's ranks: chunks of size * BATCH_CHUNK images, padded with blank
    images to a multiple of the size, each rank detecting its slice, the
    keypoints all-gathered. Returns a list of (N_i, 132) arrays. Without a
    mesh (one rank, or mesh=False): ops/sift.detect_sift_batch on `device`
    (default: the card)."""
    from sat_bundleadjust_tpu_torch.ops import sift as sift_ops

    mesh = _resolve_mesh(mesh)
    thresh = float(tracks_config.get("FT_thresh_dog", 0.0133))
    if mesh is None:
        return sift_ops.detect_sift_batch(images, thresh_dog=thresh, max_kp=max_kp,
                                          device=resolve_device(device))
    n_dev = mesh.size
    dev = mesh.device
    out = []
    chunk_size = n_dev * sift_ops.BATCH_CHUNK
    for s in range(0, len(images), chunk_size):
        group = [np.asarray(im, np.float32) for im in images[s: s + chunk_size]]
        n_real = len(group)
        pad_to = -(-n_real // n_dev) * n_dev
        group = group + [np.zeros_like(group[0])] * (pad_to - n_real)
        per = pad_to // n_dev
        feats = sift_ops.detect_sift_batch(
            group[mesh.index * per: (mesh.index + 1) * per], thresh_dog=thresh, max_kp=max_kp,
            batch_chunk=per, device=dev)
        # keypoint counts differ per image: gather the counts, then the
        # rows padded to the largest count
        counts = torch.tensor([f.shape[0] for f in feats], dtype=torch.int64, device=dev)
        counts = _all_gather_rows(counts, mesh).cpu().numpy()
        rows = torch.zeros((per, int(counts.max(initial=0)), 132), dtype=torch.float64,
                           device=dev)
        for k, f in enumerate(feats):
            rows[k, :f.shape[0]] = torch.as_tensor(f, dtype=torch.float64, device=dev)
        rows = _all_gather_rows(rows, mesh).cpu().numpy()
        # SIFT's rows are float32 (exact through the f64 transfer); an image
        # without keypoints is (0, 132) zeros, as detect_sift_batch gives it
        out.extend(rows[k, :counts[k]].astype(np.float32) if counts[k] else np.zeros((0, 132))
                   for k in range(n_real))
    return out
