"""The time series cell at a size a CPU test can run: portbench/tests/tiny.py's
copy of the benchmark, with the series' configuration cut down and the
limits that follow the size (its count floors and the .ply's metres)
scaled to it."""

from unittest import mock

from portbench.tests import tiny

TINY = {"rpc_ts5x4": {"dates": 3,
                      "views": {"per_date": 3, "h": 400, "w": 400, "n_tex": 512, "tex_octaves": 4},
                      "cli": {"FT_kp_max": 3000}}}
# 3 views of 400 x 400 px a date: ~1 480 keypoints a view, each matched in a
# same-date pair, 950-1 000 in a pair across two dates; the floor of a pair
# is a third of a same-date pair's, as on the card. A pixel of these views
# covers 5 times the ground of the card's (2000 px over the same ground), so
# the .ply's distances in metres take 5 times the card's limit.
TINY_LIMITS = {"rpc_ts5x4.sequential": {"pair_matches_min": {"min": 490},
                                        "view_tracks_min": {"min": 1000},
                                        "ply_m": {"max": 2.5}}}


def tiny_spec(root, cut=TINY):
    """tiny.tiny_spec(root), with the series cut to `cut`'s sizes and
    TINY_LIMITS' floors. Returns its Spec."""
    with mock.patch.dict(tiny.TINY, cut), mock.patch.dict(tiny.TINY_LIMITS, TINY_LIMITS):
        return tiny.tiny_spec(root)
