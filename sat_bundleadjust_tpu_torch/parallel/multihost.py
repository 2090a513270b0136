"""Multi-process deployment: one process per device, wired by
torch.distributed.

Counterpart of `sat_bundleadjust_tpu/parallel/multihost.py`. Every process
runs the same script; `initialize()` joins it to the process group before
any work, pins its card, and the stages of the pipeline then split their
per-image and per-pair work over the ranks (`partition_by_process`),
exchange it through the shared output directory's npy caches (behind
`barrier`), solve the bundle adjustment with the camera system all-reduced
(parallel/dist_solver.py), and let rank 0 alone write the outputs
(`is_main_process`).

Configuration, as in the JAX package: SATBA_COORDINATOR (host:port of rank
0), SATBA_NUM_PROCESSES and SATBA_PROCESS_ID; or torchrun's RANK,
WORLD_SIZE, MASTER_ADDR and MASTER_PORT. Without either, one process and
nothing to do.
"""

import os

import torch
import torch.distributed as dist

from sat_bundleadjust_tpu_torch.parallel.mesh import (
    get_default_mesh,
    make_mesh,
    world_rank,
    world_size,
)


def initialize(coordinator_address=None, num_processes=None, process_id=None, backend=None):
    """Join this process to the process group (no-op for one process).

    coordinator_address "host:port", num_processes and process_id default to
    SATBA_COORDINATOR, SATBA_NUM_PROCESSES and SATBA_PROCESS_ID; where none
    is set and torchrun's RANK and WORLD_SIZE are, its environment wires the
    group. backend: "nccl" by default where CUDA is available, else "gloo";
    pass "gloo" for several ranks on one card (NCCL takes one rank per
    device). Where CUDA is available the rank's card (LOCAL_RANK under
    torchrun, else process_id, modulo the cards) becomes the current device,
    so that resolve_device() gives each rank its own card."""
    coordinator_address = coordinator_address or os.environ.get("SATBA_COORDINATOR")
    if num_processes is None and "SATBA_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SATBA_NUM_PROCESSES"])
    if process_id is None and "SATBA_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SATBA_PROCESS_ID"])
    torchrun = coordinator_address is None and num_processes is None and (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ)
    if coordinator_address is None and num_processes is None and not torchrun:
        return  # single-process deployment
    if dist.is_initialized():
        raise RuntimeError("initialize: this process already belongs to a process group")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torchrun:
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", process_id))
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("initialize: a coordinator address, the number of processes and "
                             "this process's id are all needed (SATBA_COORDINATOR, "
                             "SATBA_NUM_PROCESSES, SATBA_PROCESS_ID)")
        local = process_id
    if torch.cuda.is_available():
        torch.cuda.set_device(local % torch.cuda.device_count())
    if torchrun:
        dist.init_process_group(backend=backend)
    else:
        dist.init_process_group(backend=backend, init_method="tcp://" + coordinator_address,
                                world_size=int(num_processes), rank=int(process_id))


def is_main_process():
    """True on the process that writes the shared outputs (rank 0): every
    rank computes the same results, so one writer avoids write races."""
    return world_rank() == 0


def barrier(name="satba"):
    """Block until every rank reaches this point (no-op for one process):
    e.g. every rank has written its own npy caches before any rank reads
    another's. `name` labels the point for the reader of a trace."""
    if world_size() > 1:
        dist.barrier()


def partition_by_process(n_items, mesh=None):
    """Indices of the items (images, stereo pairs) this process loads and
    computes: dealt round-robin over the mesh's ranks, as the observation
    shards are."""
    if world_size() == 1:
        return list(range(n_items))
    if mesh is None:
        mesh = get_default_mesh() or make_mesh()
    own = set(local_shard_ids(mesh))
    return [i for i in range(n_items) if (i % mesh.size) in own]


def local_shard_ids(mesh):
    """Positions along the mesh's "obs" axis that belong to this process:
    the observation shards it must load (one rank, one device, one
    shard)."""
    return [] if mesh.index is None else [mesh.index]


def shard_observations_local(pts_ind, cam_ind, pts2d, weights, n_pts, mesh, n_cam=None):
    """Every rank computes the same partition plan, but only this rank's
    shard rows are built (shard_observations owned_shards). Returns
    (sharded, local_ids)."""
    from sat_bundleadjust_tpu_torch.parallel.dist_solver import shard_observations

    local_ids = local_shard_ids(mesh)
    sharded = shard_observations(pts_ind, cam_ind, pts2d, weights, n_pts, mesh.size,
                                 n_cam=n_cam, owned_shards=local_ids)
    return sharded, local_ids
