"""Faults planted in the program's timed path, to show that the check
catches them: each takes a monkeypatch (pytest's `MonkeyPatch`) and breaks
one step of the program where it is produced. The CPU tests
(tests/test_portbench_faults.py) run them through whole runs at the test
sizes; `python3 -m portbench.readings --faults ...` reads them on the card
at the cell's own size.
"""

import numpy as np

BA = ("unchanged", "half_of_the_observations", "camera_answer_altered")
CLI = ("unchanged", "half_of_the_cameras", "keypoints_altered", "half_of_the_pairs_unmatched",
       "lower_kp_max")


def _solve_returns_its_start(monkeypatch, cams=slice(None)):
    """The BA solve's answer left at its initial state, for the cameras
    `cams` (all of them: a step that returns its state unchanged; half of
    them: half of the batch left out of the solve)."""
    from sat_bundleadjust_tpu_torch.ba.solver import BASolver

    real = BASolver.solve

    def solve(self, *args, **kwargs):
        (cam0, pts0), (cam, pts), e0, e1, info = real(self, *args, **kwargs)
        cam = cam.clone()
        cam[cams] = cam0[cams]
        if cams == slice(None):
            pts = pts0
        return (cam0, pts0), (cam, pts), e0, e1, info

    monkeypatch.setattr(BASolver, "solve", solve)


def unchanged(monkeypatch):
    _solve_returns_its_start(monkeypatch)


def half_of_the_cameras(monkeypatch):
    _solve_returns_its_start(monkeypatch, cams=slice(0, None, 2))


def half_of_the_observations(monkeypatch):
    """The stage's problem built from half of its observations (two of each
    track's four): the mean is taken over the rest."""
    from sat_bundleadjust_tpu_torch.ba.params import BAParams

    real = BAParams.from_obs_table.__func__

    def from_obs_table(cls, pts_ind, cam_ind, pts2d, *rest, **kw):
        order = np.argsort(pts_ind, kind="stable")
        first = np.searchsorted(pts_ind[order], pts_ind[order])
        keep = np.sort(order[np.arange(len(order)) - first < 2])
        return real(cls, pts_ind[keep], cam_ind[keep], pts2d[keep], *rest, **kw)

    monkeypatch.setattr(BAParams, "from_obs_table", classmethod(from_obs_table))


def camera_answer_altered(monkeypatch):
    """One camera's corrected rotation moved by 1e-5 rad where the answer
    is produced."""
    from sat_bundleadjust_tpu_torch.ba.params import BAParams

    real = BAParams.reconstruct_vars

    def reconstruct_vars(self, *args):
        pts, cams = real(self, *args)
        cams = list(cams)
        cams[0] = np.asarray(cams[0]) + np.array([1e-5] + [0.0] * 8)
        return pts, cams

    monkeypatch.setattr(BAParams, "reconstruct_vars", reconstruct_vars)


def keypoints_altered(monkeypatch):
    """View 1's keypoints detected 0.5-1 px off, each in a direction of its
    own, where detection produces them."""
    from sat_bundleadjust_tpu_torch.ops import sift

    real = sift.detect_sift_batch
    depth = [0]

    def detect(images, *args, **kwargs):
        depth[0] += 1  # the batch calls itself for its chunks: alter the outer answer
        try:
            feats = [np.array(f) for f in real(images, *args, **kwargs)]
        finally:
            depth[0] -= 1
        if depth[0] or len(feats) < 2:
            return feats
        rng = np.random.RandomState(0)
        angle = rng.uniform(0, 2 * np.pi, len(feats[1]))
        step = rng.uniform(0.5, 1.0, len(feats[1]))
        feats[1][:, 0] += step * np.cos(angle)
        feats[1][:, 1] += step * np.sin(angle)
        return feats

    monkeypatch.setattr(sift, "detect_sift_batch", detect)


def half_of_the_pairs_unmatched(monkeypatch):
    """Matching returns no match for every second pair it was given."""
    from sat_bundleadjust_tpu_torch.tracks import matching

    real = matching.match_stereo_pairs

    def match_stereo_pairs(pairs_to_match, *args, **kwargs):
        out = real(pairs_to_match, *args, **kwargs)
        dropped = {(int(i), int(j)) for i, j in list(pairs_to_match)[1::2]}
        keep = [(int(i), int(j)) not in dropped for i, j in out[:, 2:]]
        return out[np.asarray(keep, bool)]

    monkeypatch.setattr(matching, "match_stereo_pairs", match_stereo_pairs)


def lower_kp_max(monkeypatch, cap=8192):
    """Detection keeps at most `cap` keypoints a view, whatever FT_kp_max
    the configuration states."""
    from sat_bundleadjust_tpu_torch.tracks import detection

    real = detection.detect_features_image_sequence

    def detect(paths, mask_paths=None, offsets=None, tracks_config=None, **kwargs):
        if tracks_config is not None:
            cap_kp = min(cap, tracks_config.get("FT_kp_max", cap))
            tracks_config = dict(tracks_config, FT_kp_max=cap_kp)
        return real(paths, mask_paths, offsets, tracks_config, **kwargs)

    monkeypatch.setattr(detection, "detect_features_image_sequence", detect)
