"""The distributed solve's shard plan and the per-process work split:
parallel/dist_solver.shard_observations against the JAX package's, array
for array, and parallel/multihost's ownership rules."""

import numpy as np
import pytest

from sat_bundleadjust_tpu.parallel.dist_solver import shard_observations as jshard

from sat_bundleadjust_tpu_torch.parallel import mesh as tmesh
from sat_bundleadjust_tpu_torch.parallel import multihost
from sat_bundleadjust_tpu_torch.parallel.dist_solver import shard_observations as tshard
from sat_bundleadjust_tpu_torch.utils import demo


def _table(seed=0):
    """An observation table of the port's demo scene, with tracks of mixed
    lengths (2 to 5 observations): a 10-camera scene whose observations
    are dropped at random, keeping at least two a track."""
    scene = demo.make_scene_arrays(n_cam=10, n_pts=400, obs_per_pt=5, seed=seed, device="cpu")
    rng = np.random.RandomState(seed)
    keep = rng.uniform(size=len(scene["pts_ind"])) < 0.7
    keep |= np.arange(len(keep)) % 5 < 2
    w = rng.uniform(0.5, 1.5, int(keep.sum()))
    return (scene["pts_ind"][keep], scene["cam_ind"][keep], scene["pts2d"][keep], w,
            scene["pts3d"].shape[0])


@pytest.mark.parametrize("n_shards,owned", [(1, None), (2, None), (3, None), (4, None),
                                            (4, [2]), (4, [3, 1])])
def test_shard_observations_equals_jax(n_shards, owned):
    """Every key, every array, every dtype; with owned_shards only those
    rows, in their order (and the plan's global keys whole)."""
    pts_ind, cam_ind, pts2d, w, n_pts = _table()
    want = jshard(pts_ind, cam_ind, pts2d, w, n_pts, n_shards, owned_shards=owned)
    got = tshard(pts_ind, cam_ind, pts2d, w, n_pts, n_shards, owned_shards=owned)
    assert sorted(got) == sorted(want)
    assert "cam_ind_pt" in got  # the dual layouts fit this table
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    if owned is None:
        # every observation lands in exactly one slot
        idx = got["obs_index"][got["obs_index"] >= 0]
        assert np.array_equal(np.sort(idx), np.arange(len(pts_ind)))


def _world(monkeypatch, rank, size):
    monkeypatch.setattr(tmesh, "world_rank", lambda: rank)
    monkeypatch.setattr(tmesh, "world_size", lambda: size)
    monkeypatch.setattr(multihost, "world_size", lambda: size)


def test_partition_by_process_deals_round_robin(monkeypatch):
    """One process: every item. Several: items i with i % size == this
    rank's position on the mesh; the ranks' shares partition the items."""
    assert multihost.partition_by_process(7) == list(range(7))
    assert multihost.is_main_process()
    shares = []
    for rank in range(3):
        _world(monkeypatch, rank, 3)
        mesh = tmesh.Mesh(range(3), "cpu")
        assert multihost.local_shard_ids(mesh) == [rank]
        monkeypatch.setattr(multihost, "world_rank", lambda: rank)
        assert multihost.is_main_process() == (rank == 0)
        shares.append(multihost.partition_by_process(10, mesh))
        assert shares[-1] == [i for i in range(10) if i % 3 == rank]
    assert sorted(sum(shares, [])) == list(range(10))
    # a process outside the mesh owns no shard and no item
    _world(monkeypatch, 3, 4)
    outside = tmesh.Mesh(range(3), "cpu")
    assert outside.index is None
    assert multihost.local_shard_ids(outside) == []
    assert multihost.partition_by_process(10, outside) == []


def test_shard_observations_local_builds_only_the_rank_rows(monkeypatch):
    pts_ind, cam_ind, pts2d, w, n_pts = _table(seed=1)
    full = tshard(pts_ind, cam_ind, pts2d, w, n_pts, 3)
    _world(monkeypatch, 2, 3)
    mesh = tmesh.Mesh(range(3), "cpu")
    local, ids = multihost.shard_observations_local(pts_ind, cam_ind, pts2d, w, n_pts, mesh)
    assert ids == [2]
    for k in ("pts_ind", "cam_ind", "pts2d", "weights", "pt_gather", "cam_gather", "pts_loc",
              "track_global", "local_of_global", "cam_ind_pt", "pts_ind_cam"):
        np.testing.assert_array_equal(local[k], full[k][2:3], err_msg=k)
    np.testing.assert_array_equal(local["obs_index"], full["obs_index"])
    # placement: this rank's row, on its device
    row = tmesh.global_put_rows(local["pts2d"], ids, 3, mesh)
    np.testing.assert_array_equal(row.numpy(), full["pts2d"][2])
    with pytest.raises(ValueError):
        tmesh.global_put_rows(local["pts2d"], [1], 3, mesh)


def test_make_mesh_of_one_process():
    """A world never initialized is one rank: a mesh of one, this process
    at position 0; asking for more raises."""
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.size == 1 and mesh.index == 0 and mesh.group is None
    assert mesh.device.type == "cpu"
    with pytest.raises(ValueError):
        tmesh.make_mesh(n_devices=2, device="cpu")
    tmesh.set_default_mesh(mesh)
    try:
        assert tmesh.make_mesh() is mesh
    finally:
        tmesh.set_default_mesh(None)


@pytest.mark.parametrize("knob,world,want", [(True, 1, True), (False, 2, False),
                                             ("auto", 1, False), ("auto", 2, True)])
def test_distributed_knob(monkeypatch, knob, world, want):
    """True and False as given; "auto" is the distributed solve exactly
    when the world has more than one rank (one device per process)."""
    import types

    from sat_bundleadjust_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "world_size", lambda: world)
    pipe = types.SimpleNamespace(distributed=knob)
    assert pipeline.BundleAdjustmentPipeline._distributed_solve(pipe) is want
