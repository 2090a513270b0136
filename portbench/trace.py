"""The device trace of a traced run: torch.profiler over the traced units,
reduced to the device's busy time (the union of its operations' spans),
the time by device operation, and the idle gaps by what the host was doing.
"""

import bisect
import time

import torch


def union(spans):
    """Busy time of (start, end) spans and the gaps between them, in the
    spans' unit: (busy, [(gap_start, gap_end), ...])."""
    busy, gaps, end = 0, [], None
    for s, t in sorted(spans):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy, gaps


def label_gaps(gaps, host_ops):
    """Seconds of idle gap by the host operation that was running at each
    gap's start (the one that started last before it and had not ended), or
    "host (no operation)". host_ops: (name, start, end) in the gaps' unit."""
    ops = sorted(host_ops, key=lambda o: o[1])
    starts = [o[1] for o in ops]
    out = {}
    for s, t in gaps:
        i = bisect.bisect_right(starts, s) - 1
        name = "host (no operation)"
        # the innermost open operation: walk back over the ones already ended
        for j in range(i, max(i - 64, -1), -1):
            if ops[j][2] > s:
                name = ops[j][0]
                break
        out[name] = out.get(name, 0) + (t - s)
    return out


def top(totals, n=10, width=160):
    """The n largest entries as [name, value], names cut to `width`."""
    return [[k[:width], v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


class Trace:
    """A torch.profiler window over the device work between enter and exit
    (the device is synchronized at both ends; `window_s` is its length on
    the host's clock). `summary()` reads the events afterwards, outside the
    window."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def summary(self, top_n=10):
        """busy_s, window_s, the device operations [(name, start_ns, end_ns)],
        and the breakdown that the result line carries."""
        cuda = torch.autograd.DeviceType.CUDA
        device_ops, host_ops = [], []
        for e in self.prof.profiler.kineto_results.events():
            rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            (device_ops if e.device_type() == cuda else host_ops).append(rec)
        del self.prof
        if not device_ops:
            raise RuntimeError("the profiler saw no device operation in the traced window")
        busy_ns, gaps = union([(s, t) for _, s, t in device_ops])
        by_op = {}
        for name, s, t in device_ops:
            by_op[name] = by_op.get(name, 0.0) + (t - s) * 1e-9
        idle = {k: v * 1e-9 for k, v in label_gaps(gaps, host_ops).items()}
        return {"busy_s": busy_ns * 1e-9, "window_s": self.window_s, "device_ops": device_ops,
                "breakdown": {"device_ops": top(by_op, top_n), "idle_gaps": top(idle, top_n)}}
