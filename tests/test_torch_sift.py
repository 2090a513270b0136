"""Parity of the port's SIFT (ops/sift.py) with the JAX package's, on the
content-adaptive two-phase path that both take on the CPU, and the JAX
side's own detection properties (tests/test_sift_match.py:30-57) on the
port.

The same numpy images go to both. The port keeps the JAX package's float32
arithmetic and its order of operations, including the fused multiply-adds
that XLA's CPU code contracts and XLA's float32 exp; the remaining
differences come from the libraries' atan2, hypot, sin/cos and reductions in
the orientation and descriptor stages. Measured on these images: equal
keypoint counts, every JAX keypoint within 6e-4 px of one of the port's,
and 99.6-100% of the descriptors equal, the rest off by 1 in one or more of
the 128 bins. The tolerances below are those of ROADMAP.md (Queue 3).
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax
import jax.numpy as jnp

from sat_bundleadjust_tpu.ops import sift as jsift
from sat_bundleadjust_tpu.utils.demo import render_synthetic_images

from sat_bundleadjust_tpu_torch.ops import match as tmatch
from sat_bundleadjust_tpu_torch.ops import sift as tsift

torch.set_num_threads(1)
POS_TOL = 0.01  # px


@pytest.fixture(scope="module")
def detections():
    """Three rendered views (150x200), detected by both packages."""
    ims, _ = render_synthetic_images(n_cam=3, h=150, w=200, seed=0, alt=0.0)
    return ims, jsift.detect_sift_batch(ims), tsift.detect_sift_batch(ims, device="cpu")


def _pair_up(fj, ft):
    """For each JAX keypoint, the port keypoints within POS_TOL px; of
    those, the one whose descriptor is closest. Returns (found mask, max
    abs descriptor difference per found keypoint)."""
    near = cKDTree(ft[:, :2]).query_ball_point(fj[:, :2], POS_TOL)
    found = np.array([len(c) > 0 for c in near])
    diff = [np.abs(ft[c, 4:] - fj[i, 4:]).max(1).min() for i, c in enumerate(near) if c]
    return found, np.array(diff)


def test_keypoint_counts_within_one_percent(detections):
    _, fjs, fts = detections
    for fj, ft in zip(fjs, fts):
        assert fj.shape[0] > 200
        assert abs(ft.shape[0] - fj.shape[0]) <= 0.01 * fj.shape[0], (ft.shape, fj.shape)


def test_keypoint_positions(detections):
    """At least 99% of JAX's keypoints have a port keypoint within 0.01 px."""
    _, fjs, fts = detections
    for fj, ft in zip(fjs, fts):
        found, _ = _pair_up(fj, ft)
        assert found.mean() >= 0.99, found.mean()


def test_descriptors(detections):
    """The paired keypoints' descriptors are equal in at least 99% of cases
    and differ by at most 1 elsewhere; all are integers in 0..255, so the
    int8 staging accepts them."""
    _, fjs, fts = detections
    for fj, ft in zip(fjs, fts):
        _, diff = _pair_up(fj, ft)
        assert (diff == 0).mean() >= 0.99, (diff == 0).mean()
        assert diff.max() <= 1.0
        d = ft[:, 4:]
        assert d.min() >= 0 and d.max() <= 255 and np.array_equal(d, np.rint(d))
    assert tmatch.stage_frames_for_matching(list(fts), device="cpu") is not None


def _ulps(a, b):
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b))


def test_scale_space_matches_jax():
    """The 2x bilinear upsampling gives JAX's bits. Each blur (fixed taps,
    and the fixed-radius blur of a traced sigma) is a chain of fused
    multiply-adds in tap order; XLA's CPU code departs from that chain at a
    few pixels of the horizontal pass (measured: 11 of 12 000 here), so the
    blurs are held to 99.5% of the pixels bit-identical and the rest within
    one ulp, each on JAX's own input."""
    x = np.random.RandomState(0).rand(50, 60).astype(np.float32)
    up_j = np.asarray(jsift._upsample2(jnp.asarray(x)))
    up_t = tsift.upsample2(torch.as_tensor(x)[None])[0].numpy()
    np.testing.assert_array_equal(up_t, up_j)
    bj = np.asarray(jax.jit(lambda a: jsift._blur(a, 1.249))(jnp.asarray(up_j)))
    bt = tsift._blur(torch.tensor(up_j)[None], 1.249)[0].numpy()
    sig = tsift._sig_inc(3)[1]
    dj = np.asarray(jax.jit(lambda a, s: jsift._blur_dynamic(a, s, 13))(
        jnp.asarray(bj), jnp.float32(sig)))
    dt = tsift.blur(torch.tensor(bj)[None], tsift._dynamic_taps(torch.tensor(sig), 13))[0].numpy()
    for got, want in ((bt, bj), (dt, dj)):
        assert (got == want).mean() >= 0.995, (got == want).mean()
        assert _ulps(got, want).max() <= 1.0


def test_scale_space_wrappers_take_the_plain_path_on_the_cpu():
    """On CPU tensors `blur` and `upsample2` are their plain versions (the
    same bits), `blur` writes into a slot of a (B, S, H, W) scale space and
    nothing else, and neither launches: ops/launches lists both wrappers,
    and their counters stay where they were."""
    from sat_bundleadjust_tpu_torch.ops import launches

    assert tsift.blur in launches.WRAPPERS and tsift.upsample2 in launches.WRAPPERS
    before = launches.snapshot()
    x = torch.as_tensor(np.random.RandomState(1).randn(2, 9, 14).astype(np.float32))
    taps = tsift._dynamic_taps(torch.tensor(tsift._sig_inc(3)[2]), 13)
    ss = torch.zeros((2, 3, 9, 14))
    assert tsift.blur(x, taps, out=ss[:, 1]).data_ptr() == ss[:, 1].data_ptr()
    assert torch.equal(ss[:, 1], tsift._blur_plain(x, taps))
    assert not ss[:, 0].any() and not ss[:, 2].any()
    assert torch.equal(tsift.upsample2(x), tsift._upsample_plain(x))
    assert launches.snapshot() == before
    assert tsift.blur.launches == 0 and tsift.upsample2.launches == 0


@pytest.mark.parametrize("case", ["float64", "2-D", "strided rows", "even taps", "radius 17",
                                  "taps not 1-D", "out overlaps", "out shape"])
def test_blur_refuses_what_the_kernel_does_not_take(case):
    """`blur` checks its arguments on every device, before any launch."""
    x = torch.zeros((2, 8, 6))
    taps = torch.as_tensor(tsift._gaussian_kernel(1.249))
    ss = torch.zeros((2, 3, 8, 6))
    args = {
        "float64": (x.double(), taps, None),
        "2-D": (x[0], taps, None),
        "strided rows": (torch.zeros((2, 8, 12))[:, :, ::2], taps, None),
        "even taps": (x, taps[1:], None),
        "radius 17": (x, torch.ones(35), None),
        "taps not 1-D": (x, taps[None], None),
        "out overlaps": (ss[:, 1], taps, ss.view(2, 3 * 8, 6)[:, 4:12]),
        "out shape": (x, taps, torch.zeros((2, 8, 5))),
    }[case]
    with pytest.raises(ValueError):
        tsift.blur(*args)


def make_texture(h=240, w=320, seed=0, octaves=3):
    """tests/test_sift_match.py's smooth multi-scale texture."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    im = np.zeros((h, w))
    for o in range(octaves):
        im += gaussian_filter(rng.randn(h, w), sigma=2.0 ** (o + 1)) * (2.0 ** o)
    im -= im.min()
    im /= im.max()
    return (im * 255).astype(np.float32)


def test_sift_detects_keypoints():
    im = make_texture()
    feats = tsift.detect_sift(im, device="cpu")
    assert feats.shape[1] == 132 and feats.shape[0] > 30
    assert np.all(feats[:, 0] >= 0) and np.all(feats[:, 0] < im.shape[1])
    assert np.all(feats[:, 1] >= 0) and np.all(feats[:, 1] < im.shape[0])
    assert feats[:, 4:].max() <= 255.0 and feats[:, 4:].min() >= 0.0
    capped = tsift.detect_sift(im, max_kp=50, device="cpu")
    assert capped.shape == (50, 132)
    assert np.all(np.diff(capped[:, 2]) <= 0)  # the largest scales are kept


def test_sift_shift_repeatability():
    """Keypoints of a translated image match back with the known shift."""
    im = make_texture(seed=1)
    shift = 7
    f1 = tsift.detect_sift(im, device="cpu")
    f2 = tsift.detect_sift(np.roll(im, shift, axis=1), device="cpu")
    matches, _, _ = tmatch.match_pair(f1, f2, rel_thr=0.7, ransac_thr=None, device="cpu")
    assert matches is not None and matches.shape[0] >= 20
    dx = f2[matches[:, 1], 0] - f1[matches[:, 0], 0]
    dy = f2[matches[:, 1], 1] - f1[matches[:, 0], 1]
    good = (np.abs(dx - shift) < 1.0) & (np.abs(dy) < 1.0)
    assert np.mean(good) > 0.8, np.mean(good)
