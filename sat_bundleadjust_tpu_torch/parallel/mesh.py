"""The ranks a distributed stage runs over.

Counterpart of `sat_bundleadjust_tpu/parallel/mesh.py`. The JAX package
runs one program over a 1-D mesh of devices (axis "obs"); the port runs one
process per device, a rank of `torch.distributed`, and a `Mesh` names the
ranks of a stage: its process group, the ranks in it, this rank's position
on the "obs" axis and this rank's device. A world that was never
initialized counts as one rank.

Placement: replicated arrays are copied whole to the rank's device
(`global_put`); sharded arrays keep only the rank's own rows
(`global_put_rows`), the JAX package's per-host assembly, which in torch is
the natural layout.
"""

import numpy as np
import torch
import torch.distributed as dist

OBS_AXIS = "obs"

# process-wide default mesh: the pipeline's `distributed` knob pins every
# mesh-capable stage to one mesh (feature_shard.default_mesh_or_none,
# dist_solver.run_distributed_ba)
_MESH_OVERRIDE = None


def world_size():
    """Ranks of the default process group (1 when none was initialized)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def world_rank():
    """This process's rank in the default process group (0 when none)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """A 1-D mesh of ranks along OBS_AXIS.

    group: the process group of the collectives (None: the default group);
    ranks: the global ranks on the axis, in axis order; index: this rank's
    position on the axis (None when this process is not in the mesh);
    device: this rank's torch.device."""

    def __init__(self, ranks, device, group=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group
        self.device = torch.device(device)
        rank = world_rank()
        self.index = self.ranks.index(rank) if rank in self.ranks else None

    @property
    def size(self):
        return len(self.ranks)

    def __repr__(self):
        return "Mesh(ranks={}, index={}, device={})".format(self.ranks, self.index, self.device)


def set_default_mesh(mesh):
    """Pin (or clear, with None) the mesh of the stages that were not
    handed one explicitly."""
    global _MESH_OVERRIDE
    _MESH_OVERRIDE = mesh


def get_default_mesh():
    return _MESH_OVERRIDE


def make_mesh(n_devices=None, device=None):
    """A mesh over the first n_devices ranks of the world (default: all of
    them), this rank on `device` (default: its card, see
    multihost.initialize). The default mesh, where one is set, is returned
    when neither argument is given. A mesh over part of the world builds a
    new process group, which every rank of the world must do together."""
    if n_devices is None and device is None and _MESH_OVERRIDE is not None:
        return _MESH_OVERRIDE
    from sat_bundleadjust_tpu_torch import resolve_device

    world = world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError("make_mesh: {} ranks asked of a world of {}".format(n, world))
    group = None if n == world else dist.new_group(list(range(n)))
    return Mesh(range(n), resolve_device(device), group=group)


def global_put(x, mesh):
    """A replicated array on this rank's device (the whole of it)."""
    return torch.as_tensor(np.asarray(x), device=mesh.device)


def global_put_rows(local_rows, owned, n_shards, mesh):
    """This rank's row of a leading-dim-sharded (n_shards, ...) array, on
    its device. local_rows: (len(owned), ...) rows of the shards listed in
    `owned` (global indices, in local_rows order), which must hold this
    rank's shard; no rank ever holds the whole array."""
    owned = [int(s) for s in np.asarray(owned).reshape(-1)]
    if mesh.index is None or mesh.index not in owned or not 0 <= mesh.index < n_shards:
        raise ValueError("global_put_rows: shard {} of {} is not among the rows given ({})"
                         .format(mesh.index, n_shards, owned))
    return torch.as_tensor(np.asarray(local_rows[owned.index(mesh.index)]), device=mesh.device)
