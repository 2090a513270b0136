"""The launch counters of the port's kernel wrappers.

Each wrapper of a kernel in csrc/ adds one to its own `launches` attribute
where it launches its kernel; WRAPPERS lists them all. Code that records
launches into a CUDA graph takes them off the counters at the capture
(`take`), which runs nothing, and adds them back at each replay (`add`),
which is where the kernels run.
"""

from sat_bundleadjust_tpu_torch.ops import nn2_match, schur_matvec, sift, triangulate

WRAPPERS = (schur_matvec.schur_wz, nn2_match.nn2_batched_i8, nn2_match.nn2_batched,
            nn2_match.nn2_single, sift.blur, sift.upsample2, triangulate.rpc_triangulate)


def snapshot():
    """Every wrapper's count, in the order of WRAPPERS."""
    return tuple(w.launches for w in WRAPPERS)


def take(before):
    """The launches each wrapper counted since snapshot() returned `before`;
    the counters are set back to `before`."""
    counts = tuple(w.launches - b for w, b in zip(WRAPPERS, before))
    for w, b in zip(WRAPPERS, before):
        w.launches = b
    return counts


def add(counts):
    """Adds counts (as `take` returns them) to the wrappers' counters."""
    for w, n in zip(WRAPPERS, counts):
        w.launches += n
