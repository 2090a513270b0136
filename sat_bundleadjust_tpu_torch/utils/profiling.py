"""Profiling hooks.

Counterpart of `sat_bundleadjust_tpu/utils/profiling.py`: the stage timer
that prints wall-clock deltas, and device tracing. Set
SATBA_PROFILE_DIR=/path and wrap a region in `with device_trace("ba_solve"):`
to capture a torch.profiler trace of it (host operators, and the card's
kernels and copies where CUDA is available), written as a Chrome trace to
<SATBA_PROFILE_DIR>/<name>/ (open it in chrome://tracing or Perfetto)."""

import contextlib
import os
import time


@contextlib.contextmanager
def device_trace(name):
    """torch.profiler trace of the enclosed region if SATBA_PROFILE_DIR is
    set; nothing otherwise. Each trace is a new file,
    <dir>/<name>/<name>.<milliseconds since the epoch>.pt.trace.json."""
    trace_dir = os.environ.get("SATBA_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(trace_dir, name)
    os.makedirs(path, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield
        if cuda:
            # the region's kernels finish inside the trace
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(path, "{}.{}.pt.trace.json".format(name, int(time.time() * 1000))))


@contextlib.contextmanager
def stage_timer(label, verbose=True):
    """Wall-clock stage timer: prints "<label> done in <s> seconds"."""
    t0 = time.time()
    yield
    if verbose:
        print("{} done in {:.2f} seconds".format(label, time.time() - t0), flush=True)
