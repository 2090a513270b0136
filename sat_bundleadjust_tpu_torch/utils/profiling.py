"""Profiling hooks: the program's spans, device tracing, the stage timer.

Counterpart of `sat_bundleadjust_tpu/utils/profiling.py`: the stage timer
that prints wall-clock deltas, and device tracing. Set
SATBA_PROFILE_DIR=/path and wrap a region in `with device_trace("ba_solve"):`
to capture a torch.profiler trace of it (host operators, the program's
spans, and the card's kernels and copies where CUDA is available), written
as a Chrome trace to <SATBA_PROFILE_DIR>/<name>/ (open it in
chrome://tracing or Perfetto); `cli.main` traces the whole run as "cli".

`span(name, timing, key, **attrs)` marks one phase of the program. It
always times its wall (and adds it to timing[key] where a dict is given).
While a torch.profiler is recording, and only then, it also opens a
profiler range of that name, so the phase sits in the profiler's trace
beside the device's operations, and keeps the span in memory:
`spans()` returns them as (id, parent id, name, start_ns, end_ns, attrs),
stamped with time.time_ns() inside the range (the clock of the profiler's
events), the parent being the span open on the same thread when it
started; `reset()` clears them. Garbage collections under the profiler are
kept as `python.gc` spans too (attributes `generation`, `collected`)."""

import contextlib
import gc
import itertools
import os
import threading
import time

import torch

# the profiler's own flag: one C call, ~0.1-0.2 us
_profiling = torch._C._autograd._profiler_enabled
# The range a span opens: an operator-scope record (a host event of the
# span's name). torch.profiler.record_function's user-scope range would also
# make the profiler stretch a "gpu_user_annotation" event over the device
# work the range launched, which a trace reader takes for a device
# operation: the device's gaps inside the range then read as busy.
record_function = torch._C._profiler._RecordFunctionFast

_SPANS = []
_IDS = itertools.count(1)
_OPEN = threading.local()  # .ids: the ids of the spans open on this thread


def spans():
    """The spans kept since the last reset(), in the order they ended."""
    return list(_SPANS)


def reset():
    """Forget the spans kept so far."""
    _SPANS.clear()


def _open_ids():
    ids = getattr(_OPEN, "ids", None)
    if ids is None:
        ids = _OPEN.ids = []
    return ids


class span:
    """One phase of the program, as a context manager:

        with span("tracks.matching", self.timing, "matching_s"):
            ...

    `seconds` holds the wall (time.perf_counter) once the block has ended,
    and is added to timing[key] where `timing` is given (a key not yet
    there starts at 0). `attrs` (the keyword arguments; counters may be
    added to it inside the block) go with the span where it is kept, which
    is only while a torch.profiler records (see the module's docstring)."""

    __slots__ = ("name", "timing", "key", "attrs", "seconds", "_t0", "_range", "_id", "_parent",
                 "_start")

    def __init__(self, name, timing=None, key=None, **attrs):
        self.name, self.timing, self.key, self.attrs = name, timing, key, attrs
        self._range = None

    def __enter__(self):
        if _profiling():
            self._range = record_function(self.name)
            self._range.__enter__()
            ids = _open_ids()
            self._parent = ids[-1] if ids else None
            self._id = next(_IDS)
            ids.append(self._id)
            self._start = time.time_ns()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self.timing is not None:
            self.timing[self.key] = self.timing.get(self.key, 0.0) + self.seconds
        if self._range is not None:
            end = time.time_ns()
            _open_ids().remove(self._id)
            _SPANS.append((self._id, self._parent, self.name, self._start, end, self.attrs))
            self._range.__exit__(*exc)
            self._range = None
        return False


_GC = {}  # thread id -> (start_ns, parent id) of the collection in progress


def _gc_span(phase, info, _profiling=_profiling, _time_ns=time.time_ns):
    """gc.callbacks hook: each collection that starts while a profiler
    records is kept as a `python.gc` span (kept only in spans(): a
    collection can start inside the profiler's own code, so it opens no
    profiler range)."""
    key = threading.get_ident()
    if phase == "start":
        if _profiling():
            ids = _open_ids()
            _GC[key] = (_time_ns(), ids[-1] if ids else None)
    elif key in _GC:
        start, parent = _GC.pop(key)
        _SPANS.append((next(_IDS), parent, "python.gc", start, _time_ns(),
                       {"generation": info["generation"], "collected": info["collected"]}))


if _gc_span not in gc.callbacks:
    gc.callbacks.append(_gc_span)


@contextlib.contextmanager
def device_trace(name):
    """torch.profiler trace of the enclosed region if SATBA_PROFILE_DIR is
    set; nothing otherwise. Each trace is a new file,
    <dir>/<name>/<name>.<milliseconds since the epoch>.pt.trace.json; it
    holds the region's spans as the profiler's ranges."""
    trace_dir = os.environ.get("SATBA_PROFILE_DIR")
    if not trace_dir:
        yield
        return
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
