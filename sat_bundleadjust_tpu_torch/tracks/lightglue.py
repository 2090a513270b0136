"""Optional LightGlue matching backend.

Counterpart of `sat_bundleadjust_tpu/tracks/lightglue.py`. LightGlue is an
optional external package (github.com/cvg/LightGlue), imported only when
this backend runs; without it the backend raises ImportError with the
install instructions. As there:
  * the RootSIFT normalization (L1-normalize, then the square root) is
    done here, so the feature conversion works without the package;
  * the geometric filter is the package's own RANSAC
    (`ops/ransac.ransac_fundamental`), not cv2.findFundamentalMat;
  * one matcher object is kept per device, so its weights load once.
The features are torch tensors on `device` (default: the card).
"""

import numpy as np
import torch

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.ops.ransac import ransac_fundamental

_MATCHER_CACHE = {}

MISSING_PACKAGE = ("FT_sift_matching='lightglue' requires torch and the LightGlue "
                   "package (pip install git+https://github.com/cvg/LightGlue)")


def lightglue_available():
    """True when the lightglue package can be imported."""
    try:
        import lightglue  # noqa: F401
    except ImportError:
        return False
    return True


def _rootsift(desc):
    """RootSIFT: L1-normalize each descriptor, then take the square root."""
    l1 = desc.abs().sum(dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.sqrt(desc / l1)


def sift_to_lightglue_format(sift_features, image_size=None, device=None, rootsift=True):
    """(N, 132) feature rows [col, row, scale, orientation_deg, 128-desc]
    -> the dict of batched float32 tensors on device that LightGlue takes.
    NaN-padded rows are dropped."""
    dev = resolve_device(device)
    sift_features = np.asarray(sift_features)
    assert sift_features.shape[1] == 132
    sift_features = sift_features[~np.isnan(sift_features[:, 0])]
    feats = {
        "keypoints": sift_features[:, :2],
        "scales": sift_features[:, 2],
        "oris": np.deg2rad(sift_features[:, 3]),
        "descriptors": sift_features[:, 4:],
    }
    if image_size is not None:
        feats["image_size"] = np.asarray(image_size)
    feats = {k: torch.tensor(v[np.newaxis, ...], dtype=torch.float32, device=dev)
             for k, v in feats.items()}
    if rootsift:
        feats["descriptors"] = _rootsift(feats["descriptors"])
    return feats


def _get_matcher(device):
    """One LightGlue instance per device, weights loaded once."""
    key = ("sift", str(device))
    if key not in _MATCHER_CACHE:
        from lightglue import LightGlue

        _MATCHER_CACHE[key] = LightGlue(features="sift").eval().to(device)
    return _MATCHER_CACHE[key]


def lightglue_matching(features_i, features_j, ransac_thr=0.3, max_matches=300, device=None):
    """Match two (N, 132) feature arrays with LightGlue, then RANSAC.

    Returns (matches_ij (M, 2) int64 or None, n_matches, n_matches_final):
    the matcher's count, then the count after the geometric filter, keeping
    at most `max_matches` by descending matcher confidence."""
    if not lightglue_available():
        raise ImportError(MISSING_PACKAGE)
    dev = resolve_device(device)
    feats0 = sift_to_lightglue_format(features_i, device=dev)
    feats1 = sift_to_lightglue_format(features_j, device=dev)
    matcher = _get_matcher(dev)
    with torch.no_grad():
        out = matcher({"image0": feats0, "image1": feats1})

    matches, scores = out["matches"], out["scores"]
    # batched ([1, M, 2]) or a list per image, depending on the version
    if isinstance(matches, (list, tuple)) or matches.dim() == 3:
        matches, scores = matches[0], scores[0]
    matches_ij = matches.detach().cpu().numpy().reshape(-1, 2)
    scores_ij = scores.detach().cpu().numpy().reshape(-1)
    n_matches = matches_ij.shape[0]
    if n_matches == 0:
        return None, 0, 0

    if ransac_thr is not None and n_matches >= 8:
        pts_i = np.asarray(features_i)[matches_ij[:, 0], :2]
        pts_j = np.asarray(features_j)[matches_ij[:, 1], :2]
        _, inliers = ransac_fundamental(pts_i, pts_j, thr=ransac_thr)
        if inliers is None or inliers.sum() == 0:
            return None, n_matches, 0
        matches_ij = matches_ij[inliers]
        scores_ij = scores_ij[inliers]

    n_final = matches_ij.shape[0]
    if max_matches is not None and n_final > max_matches:
        matches_ij = matches_ij[np.argsort(-scores_ij)[:max_matches]]
        n_final = max_matches
    return matches_ij.astype(np.int64), n_matches, n_final
