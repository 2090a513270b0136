"""Keypoint detection over an image sequence.

Counterpart of `sat_bundleadjust_tpu/tracks/detection.py` for one process,
with its two backends:
* "tpu" (the reference name "s2p" is an alias): the package's own
  scale-space SIFT (`ops/sift.py`); same-shape images are detected in
  batches on `device`, and a mask keeps the keypoints that fall inside it;
* "opencv": cv2 SIFT on the host, on percentile-equalized uint8 with the
  mask passed to cv2, images spread over FT_n_proc threads (cv2 releases
  the GIL). This is the detector the user chose, as in the JAX package;
  what follows detection runs on `device` either way.
Every image's keypoints come out in the common layout, (N, 132) float rows
(col, row, scale, orientation, 128-d descriptor), sorted by descending
scale and NaN-padded to FT_kp_max. The npy cache of features/ is read and
written as there. With several processes (parallel/multihost.py) each
reads and detects only its own images and the processes exchange their
keypoints through the features/ cache of the shared output directory.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.parallel import multihost
from sat_bundleadjust_tpu_torch.parallel.mesh import world_size
from sat_bundleadjust_tpu_torch.utils import io as loader
from sat_bundleadjust_tpu_torch.utils.io import flush_print, get_id
from sat_bundleadjust_tpu_torch.utils.profiling import span


def _top_k_by_scale(features, max_kp):
    """Sort by descending scale and NaN-pad to max_kp."""
    if features.shape[0] > 0:
        features = features[np.argsort(-features[:, 2], kind="stable")]
    if max_kp is None:
        return features
    out = np.full((max_kp, 132), np.nan)
    n = min(features.shape[0], max_kp)
    out[:n] = features[:n]
    return out


def _apply_mask(features, mask):
    pts = features[:, :2].astype(np.int64)
    h, w = mask.shape
    pts[:, 0] = np.clip(pts[:, 0], 0, w - 1)
    pts[:, 1] = np.clip(pts[:, 1], 0, h - 1)
    inside = mask[pts[:, 1], pts[:, 0]] > 0
    return features[inside]


def detect_opencv(image, mask=None):
    """cv2 SIFT on an equalized image: (N, 132) rows."""
    import cv2

    sift = cv2.SIFT_create()
    kp, des = sift.detectAndCompute(
        image.astype(np.uint8), None if mask is None else mask.astype(np.uint8))
    if not kp:
        return np.zeros((0, 132))
    return np.array([[k.pt[0], k.pt[1], k.size, k.angle, *d] for k, d in zip(kp, des)])


def detect_tpu(image, mask=None, thresh_dog=0.0133, n_octaves=8, n_scales=3, max_kp=None,
               device=None):
    """The package's SIFT (ops/sift.py) on one image, on `device` (default:
    the card); with a mask, the keypoints inside it. (N, 132) rows."""
    from sat_bundleadjust_tpu_torch.ops.sift import detect_sift

    feats = detect_sift(np.asarray(image, dtype=np.float32), thresh_dog=thresh_dog,
                        n_octaves=n_octaves, n_scales=n_scales, max_kp=max_kp, device=device)
    if mask is not None and feats.shape[0] > 0:
        feats = _apply_mask(feats, mask)
    return feats


BACKENDS = ("tpu", "opencv")


def check_backend(backend):
    """Raise for a FT_sift_detection the port does not run."""
    if backend not in BACKENDS:
        raise ValueError("unknown FT_sift_detection: {}".format(backend))


def detect_features_image_sequence(geotiff_paths, mask_paths=None, offsets=None,
                                   tracks_config=None, device=None, timing=None, counts=None):
    """Detect keypoints over an image sequence, with the features/ npy cache.

    geotiff_paths: image paths (or arrays already in memory, see
    utils/io.load_image); mask_paths: optional per-image .npy masks;
    offsets: optional crop offsets. Returns a list of (FT_kp_max, 132)
    arrays (unpadded when tracks_config is None). `timing` (a dict), if
    given, receives detector_s: the wall of reading and detecting the
    uncached images (equalization and cv2 for opencv, the SIFT batches for
    tpu), without the caches. `counts` (a dict), if given, adds the
    images read from the features/ cache (features_cached) and the others
    (features_detected, by this process or another)."""
    from sat_bundleadjust_tpu_torch.ops.sift import detect_sift_batch
    from sat_bundleadjust_tpu_torch.utils.config import init_feature_tracks_config

    dev = resolve_device(device)
    config = init_feature_tracks_config(tracks_config)
    max_kp = None if tracks_config is None else config["FT_kp_max"]
    backend = config["FT_sift_detection"]
    check_backend(backend)

    # several processes: each reads and detects only its own images and
    # publishes them to the shared features/ cache
    multiproc = world_size() > 1
    if multiproc and not (config["FT_save"] and "out_dir" in config):
        raise ValueError("multi-process feature detection needs FT_save and out_dir "
                         "(the npy exchange through a shared directory)")
    owned = set(multihost.partition_by_process(len(geotiff_paths))) if multiproc else None

    n = len(geotiff_paths)
    resolved = [None] * n
    pending = []  # (i, path, offset, mask) still to detect
    remote = []  # uncached images another process detects
    with span("detection.cache_read"):
        if not config["FT_reset"] and "in_dir" in config:
            for i, path in enumerate(geotiff_paths):
                npy_in = os.path.join(config["in_dir"], "features/{}.npy".format(get_id(path)))
                if os.path.exists(npy_in):
                    resolved[i] = np.load(npy_in)
    n_cached = sum(f is not None for f in resolved)
    if counts is not None:
        counts["features_cached"] = counts.get("features_cached", 0) + n_cached
        counts["features_detected"] = counts.get("features_detected", 0) + n - n_cached
    for i, path in enumerate(geotiff_paths):
        if resolved[i] is not None:
            continue
        if owned is not None and i not in owned:
            remote.append(i)
            continue
        offset_i = None if offsets is None else offsets[i]
        mask = None if mask_paths is None else np.load(mask_paths[i])
        pending.append((i, path, offset_i, mask))

    with span("detection.detector", timing, "detector_s"):
        if backend == "opencv":
            def load_and_detect(item):
                i, path, offset_i, mask = item
                with span("detection.load", frame=i):
                    image = loader.load_image(path, offset=offset_i, equalize=True)
                with span("detection.opencv", frame=i):
                    return i, _top_k_by_scale(detect_opencv(image, mask), max_kp)

            n_proc = int(config.get("FT_n_proc", 1) or 1)
            if n_proc > 1 and len(pending) > 1:
                with ThreadPoolExecutor(max_workers=n_proc) as pool:
                    results = list(pool.map(load_and_detect, pending))
            else:
                results = [load_and_detect(item) for item in pending]
            for i, feats in results:
                resolved[i] = feats
        else:
            # same-shape images go through the pyramid together
            by_shape = {}
            for i, path, offset_i, mask in pending:
                with span("detection.load", frame=i):
                    image = loader.load_image(path, offset=offset_i, equalize=False)
                by_shape.setdefault(np.asarray(image).shape, []).append((i, image, mask))
            thresh = float(config.get("FT_thresh_dog", 0.0133))
            for group in by_shape.values():
                feats_list = detect_sift_batch(
                    [np.asarray(im, dtype=np.float32) for _, im, _ in group], thresh_dog=thresh,
                    max_kp=max_kp, device=dev)
                with span("detection.mask_topk", frames=len(group)):
                    for (i, _, mask), feats in zip(group, feats_list):
                        if mask is not None and feats.shape[0] > 0:
                            feats = _apply_mask(feats, mask)
                        resolved[i] = _top_k_by_scale(feats, max_kp)

    if multiproc:
        # publish this process's images (owned exclusively: no write races;
        # cache hits are relocated by rank 0 only), then read the others'
        detected = {i for i, *_ in pending}
        for i in range(n):
            if resolved[i] is None or (i not in detected and not multihost.is_main_process()):
                continue
            npy_out = os.path.join(config["out_dir"], "features/{}.npy".format(
                get_id(geotiff_paths[i])))
            if not os.path.exists(npy_out):
                os.makedirs(os.path.dirname(npy_out), exist_ok=True)
                np.save(npy_out, resolved[i])
        multihost.barrier("feature_detection")
        for i in remote:
            resolved[i] = np.load(os.path.join(config["out_dir"], "features/{}.npy".format(
                get_id(geotiff_paths[i]))))

    features = []
    with span("detection.write"):
        for i, path in enumerate(geotiff_paths):
            features_i = resolved[i]
            flush_print("{} keypoints in image {}".format(
                int(np.sum(~np.isnan(features_i[:, 0]))), i))
            if config["FT_save"] and "out_dir" in config and not multiproc:
                npy_out = os.path.join(config["out_dir"], "features/{}.npy".format(get_id(path)))
                os.makedirs(os.path.dirname(npy_out), exist_ok=True)
                np.save(npy_out, features_i)
            features.append(features_i)
    return features
