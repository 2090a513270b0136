"""Faults planted in the program's timed path of a time series, to show that
the series' check (portbench/reference/ts_outputs.py) catches them: each
takes a monkeypatch (pytest's `MonkeyPatch`), set in the benchmark's own
process, and breaks one step of the program's `ba_sequential` where it is
produced. The CPU tests (tests/test_torch_ts_reference.py) run them through
whole series at test sizes; on the card a script sets them on
`portbench.faults` and calls `portbench.readings.main([... "--faults",
...])`.
"""

import os

SERIES = ("dates_alone", "frozen_moved", "date_left_at_its_start",
          "half_of_the_cross_date_pairs_unmatched", "earlier_dates_detected_again")


def dates_alone(monkeypatch):
    """The series run with n_dates 0: each date adjusted on its own, in a
    gauge of its own."""
    from sat_bundleadjust_tpu_torch.timeseries import Scene

    real = Scene._load

    def _load(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.n_dates = 0

    monkeypatch.setattr(Scene, "_load", _load)


def frozen_moved(monkeypatch):
    """The previous dates' cameras handed to the pipeline as free ones
    (n_adj 0): each date adjusts them again and writes them anew."""
    from sat_bundleadjust_tpu_torch.timeseries import Scene

    real = Scene.set_ba_input_data

    def set_ba_input_data(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.n_adj = 0

    monkeypatch.setattr(Scene, "set_ba_input_data", set_ba_input_data)


def date_left_at_its_start(monkeypatch, date=1):
    """Every BA solve of the series' date `date` (0 the first) returns its
    initial state: that date's views keep their biased RPCs."""
    from sat_bundleadjust_tpu_torch.ba.solver import BASolver
    from sat_bundleadjust_tpu_torch.timeseries import Scene

    real_ba, real_solve = Scene.bundle_adjust, BASolver.solve
    now = {"date": None}

    def bundle_adjust(self):
        self._fault_dates = getattr(self, "_fault_dates", 0) + 1
        now["date"] = self._fault_dates - 1
        try:
            return real_ba(self)
        finally:
            now["date"] = None

    def solve(self, *args, **kwargs):
        (cam0, pts0), (cam, pts), e0, e1, info = real_solve(self, *args, **kwargs)
        if now["date"] == date:
            cam, pts = cam0, pts0
        return (cam0, pts0), (cam, pts), e0, e1, info

    monkeypatch.setattr(Scene, "bundle_adjust", bundle_adjust)
    monkeypatch.setattr(BASolver, "solve", solve)


def half_of_the_cross_date_pairs_unmatched(monkeypatch):
    """Matching is given every second pair across two dates to skip: those
    pairs get no match and no cache file."""
    from sat_bundleadjust_tpu_torch.tracks import matching

    real = matching.match_stereo_pairs

    def match_stereo_pairs(pairs_to_match, features, footprints, utm_coords, tracks_config,
                           F=None, **kwargs):
        day = [os.path.basename(str(f))[:8] for f in features]
        pairs = [(int(i), int(j)) for i, j in pairs_to_match]
        dropped = set([p for p in pairs if day[p[0]] != day[p[1]]][1::2])
        keep = [k for k, p in enumerate(pairs) if p not in dropped]
        F = None if F is None else [F[k] for k in keep]
        return real([pairs[k] for k in keep], features, footprints, utm_coords, tracks_config,
                    F, **kwargs)

    monkeypatch.setattr(matching, "match_stereo_pairs", match_stereo_pairs)


def earlier_dates_detected_again(monkeypatch):
    """Detection handed FT_reset: each date detects the keypoints of its
    frozen views anew instead of reading them from the features/ cache."""
    from sat_bundleadjust_tpu_torch.tracks import detection

    real = detection.detect_features_image_sequence

    def detect(paths, mask_paths=None, offsets=None, tracks_config=None, **kwargs):
        if tracks_config is not None:
            tracks_config = dict(tracks_config, FT_reset=True)
        return real(paths, mask_paths, offsets, tracks_config, **kwargs)

    monkeypatch.setattr(detection, "detect_features_image_sequence", detect)
