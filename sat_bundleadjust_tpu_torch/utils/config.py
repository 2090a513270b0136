"""Feature tracking configuration.

A copy of `sat_bundleadjust_tpu/utils/config.py`.

Mirrors the reference's init_feature_tracks_config
(feature_tracks/ft_utils.py:263-352): same 15 FT_* keys and default values,
with unknown keys passed through. Differences: the default detector and
matcher names are the TPU-native backends ("tpu"), and the reference names
("s2p", "epipolar_based") are accepted as aliases."""

FT_KEYS = [
    "FT_sift_detection",
    "FT_sift_matching",
    "FT_rel_thr",
    "FT_abs_thr",
    "FT_ransac",
    "FT_kp_max",
    "FT_kp_aoi",
    "FT_K",
    "FT_priority",
    "FT_predefined_pairs",
    "FT_filter_pairs",
    "FT_n_proc",
    "FT_reset",
    "FT_save",
    "FT_skysat_sensor_aware",
]

FT_DEFAULTS = [
    "tpu",
    "epipolar_based",
    0.6,
    250,
    0.3,
    60000,
    False,
    0,
    ["length", "scale", "cost"],
    [],
    True,
    1,
    False,
    True,
    False,
]

_DETECTION_ALIASES = {"s2p": "tpu"}


def init_feature_tracks_config(config=None):
    """Reference: ft_utils.py:263-352 (same keys/defaults, unknown keys
    passed through at :343-344)."""
    out = {}
    if config is not None:
        for k, v in zip(FT_KEYS, FT_DEFAULTS):
            out[k] = config.get(k, v)
        for k in set(config.keys()) - set(FT_KEYS):
            out[k] = config[k]
    else:
        out = dict(zip(FT_KEYS, FT_DEFAULTS))
    out["FT_sift_detection"] = _DETECTION_ALIASES.get(
        out["FT_sift_detection"], out["FT_sift_detection"]
    )
    if out["FT_sift_detection"] == "opencv":
        out["FT_preprocess"] = True
    return out
