"""The feature stages over the ranks of a mesh (parallel/feature_shard.py)
on two gloo ranks on the CPU: they must give exactly the one-device
results, as tests/test_feature_shard.py asserts of the JAX package's mesh.

On the CPU each rank's 2-NN is the plain nn2 version (ops/nn2_match.py;
the one-sided epipolar gate of the kernels and of JAX's packed_2nn_lax),
and the one-device path is ops/match.match_pairs_2nn_batched (JAX's CPU
matcher, the symmetric gate): the two are compared without a gate (F None,
as bruteforce matching runs), and the gated pairs against the JAX
package's match_pairs_mesh, which packs and gates as the port does.

Run as a program, this file is one rank's worker:
    python tests/test_torch_feature_shard.py <rank> <world> <port> <out prefix>
"""

import sys

import numpy as np

TRACKS = {"FT_sift_matching": "epipolar_based", "FT_rel_thr": 0.6, "FT_abs_thr": 250.0,
          "FT_thresh_dog": 0.0133}
MAX_KP = 500


def synthetic_pairs(n_img=4, n_kp=300, seed=0):
    """Keypoints of images that share a bank of descriptors (plus noise),
    NaN-padded rows included, every pair twice: without F, and with an
    affine F that keeps the true matches, or (every third pair) one that
    kills all of them (tests/test_feature_shard.py's recipe)."""
    rng = np.random.RandomState(seed)
    bank = rng.randn(n_kp, 128) * 20 + 100
    cols = rng.uniform(0, 400, n_kp)
    rows = rng.uniform(0, 300, n_kp)
    feats = []
    for i in range(n_img):
        desc = bank + rng.randn(n_kp, 128) * 0.5
        f = np.hstack([(cols + 5.0 * i + rng.randn(n_kp) * 0.1)[:, None],
                       (rows - 3.0 * i + rng.randn(n_kp) * 0.1)[:, None],
                       rng.uniform(1, 4, (n_kp, 1)), rng.uniform(0, 6.28, (n_kp, 1)), desc])
        feats.append(np.vstack([f[: n_kp - 10 * i], np.full((16, 132), np.nan)]))
    pairs = [(feats[i], feats[j]) for i in range(n_img) for j in range(i + 1, n_img)]
    F_keep = np.array([[0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])  # rows agree: |y_i - y_j| small
    F_kill = np.array([[0, 0, 0], [0, 0, 1], [0, -1, 1e9]], float)
    Fs = [F_kill if q % 3 == 2 else F_keep for q in range(len(pairs))]
    return pairs, [None] * len(pairs), Fs


def synthetic_images(n=5, seed=3):
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    return [gaussian_filter(rng.rand(96, 128), 1.5).astype(np.float32) * 255 for _ in range(n)]


def _worker(rank, world, port, prefix):
    import torch
    import torch.distributed as dist

    from sat_bundleadjust_tpu_torch.parallel import multihost
    from sat_bundleadjust_tpu_torch.parallel.feature_shard import (
        default_mesh_or_none,
        detect_batches_mesh,
        match_pairs_mesh,
    )
    from sat_bundleadjust_tpu_torch.parallel.mesh import make_mesh, set_default_mesh

    torch.set_num_threads(1)
    multihost.initialize("127.0.0.1:" + port, int(world), int(rank), backend="gloo")
    mesh = make_mesh(device="cpu")
    set_default_mesh(mesh)
    assert default_mesh_or_none() is mesh
    pairs, no_F, Fs = synthetic_pairs()
    out = {}
    for tag, F in (("free", no_F), ("gated", Fs)):
        for q, (nn, acc) in enumerate(match_pairs_mesh(pairs, F, TRACKS, mesh=mesh,
                                                       max_bytes=2 << 20)):
            out["{}_nn{}".format(tag, q)] = nn
            out["{}_acc{}".format(tag, q)] = acc
    for k, f in enumerate(detect_batches_mesh(synthetic_images(), TRACKS, mesh=mesh,
                                              max_kp=MAX_KP)):
        out["det{}".format(k)] = f
    # a mesh over part of the world: a group of its own, which every rank
    # builds; the rank outside it holds no position on its axis
    part = make_mesh(n_devices=1, device="cpu")
    assert part.size == 1 and part.index == (0 if int(rank) == 0 else None)
    np.savez("{}{}.npz".format(prefix, rank), **out)
    dist.destroy_process_group()


def test_feature_stages_at_two_ranks_equal_one_device(tmp_path):
    from test_torch_ranks import run_ranks

    from sat_bundleadjust_tpu.parallel.feature_shard import match_pairs_mesh as jmatch
    from sat_bundleadjust_tpu.parallel.mesh import make_mesh as jmake_mesh
    from sat_bundleadjust_tpu.utils.config import init_feature_tracks_config as jconfig

    from sat_bundleadjust_tpu_torch.parallel.feature_shard import (
        default_mesh_or_none,
        detect_batches_mesh,
        match_pairs_mesh,
    )

    logs = run_ranks(__file__, [str(tmp_path / "rank")], 2, timeout=240)
    res = [dict(np.load(str(tmp_path / "rank{}.npz".format(r)))) for r in range(2)]
    assert sorted(res[0]) == sorted(res[1])
    for k in res[0]:
        assert np.array_equal(res[0][k], res[1][k]), (k, logs[1][-2000:])
    r = res[0]

    # one process: no mesh, the one-device entry points
    assert default_mesh_or_none() is None
    pairs, no_F, Fs = synthetic_pairs()
    one = match_pairs_mesh(pairs, no_F, TRACKS, device="cpu")
    n_acc = 0
    for q, (nn, acc) in enumerate(one):
        np.testing.assert_array_equal(r["free_acc{}".format(q)], acc)
        np.testing.assert_array_equal(r["free_nn{}".format(q)][acc], nn[acc])
        n_acc += int(acc.sum())
    assert n_acc > 1000  # planted correspondences found

    cfg = jconfig(dict(TRACKS))
    for tag, F in (("free", no_F), ("gated", Fs)):
        want = jmatch(pairs, F, cfg, mesh=jmake_mesh(n_devices=2), max_bytes=2 << 20)
        for q, (nn, acc) in enumerate(want):
            np.testing.assert_array_equal(r["{}_acc{}".format(tag, q)], np.asarray(acc))
            np.testing.assert_array_equal(r["{}_nn{}".format(tag, q)], np.asarray(nn))
    killed = [r["gated_acc{}".format(q)].sum() for q in range(len(pairs)) if q % 3 == 2]
    kept = [r["gated_acc{}".format(q)].sum() for q in range(len(pairs)) if q % 3 != 2]
    assert max(killed) == 0 and min(kept) > 100

    plain = detect_batches_mesh(synthetic_images(), TRACKS, mesh=False, max_kp=MAX_KP,
                                device="cpu")
    for k, f in enumerate(plain):
        assert f.shape[0] > 0
        np.testing.assert_array_equal(r["det{}".format(k)], f)


if __name__ == "__main__":
    _worker(*sys.argv[1:])
