"""The program's spans in a traced run, held against the device's work.

While the profiler records, the port keeps one span per phase of its work
(sat_bundleadjust_tpu_torch/utils/profiling.py): (id, parent id, name,
start_ns, end_ns, attrs), stamped on the clock of the profiler's events, so
they compare with the traced window's device operations
(run["trace"]["device_ops"], (name, start_ns, end_ns)). The readers of the
span metrics (portbench/metrics/) take the arithmetic from here: a span's
idle time is its length less its overlap with the union of the device's
operations.

Run as a module, it makes one traced run of a cell and writes what the
spans tell of it: the idle time of the window by the innermost span the
host was in, the share of the idle time that spans below the unit's root
cover, the spans' count per unit, and what a span costs:

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s> --out <file.json>
"""

import argparse
import bisect
import json
import time

from portbench.trace import union

# the span that encloses a whole unit of a cell, where the program opens one
ROOTS = ("cli.main",)
# the spans' time.time_ns() and the profiler's clock agree within ~0.2 ms
MARGIN_NS = 100_000_000


def recorded(run):
    """The spans the program kept (its utils.profiling.spans()) in the traced
    window of `run`. The program keeps spans only while a profiler records,
    and the window ends when its profiler stops, after the device's last
    operation; so the window began no earlier than its last operation's end
    less its length (window_s), and the spans that start before that, with
    MARGIN_NS for the two clocks, belong to an earlier traced window of the
    same process (a run's warm-up unit lies between two windows). Host work
    before the window's first device operation is kept. None where there is
    no trace or no span (a program that keeps none)."""
    trace = run.get("trace")
    if trace is None or not trace["device_ops"]:
        return None
    try:
        from sat_bundleadjust_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    start = max(e for _, _, e in trace["device_ops"]) - int(trace["window_s"] * 1e9) - MARGIN_NS
    return [s for s in profiling.spans() if s[3] >= start] or None


class Busy:
    """The union of the device operations' spans, as a step function:
    busy(a, b) is the time inside [a, b] in which some operation ran."""

    def __init__(self, device_ops):
        ops = [(s, e) for _, s, e in device_ops]
        total, gaps = union(ops)
        self.lo = min(s for s, _ in ops) if ops else 0
        self.hi = max(e for _, e in ops) if ops else 0
        # the merged intervals lie between the gaps
        edges = [self.lo] + [x for g in gaps for x in g] + [self.hi]
        self.starts, self.ends = edges[0::2], edges[1::2]
        self.before = [0]
        for s, e in zip(self.starts, self.ends):
            self.before.append(self.before[-1] + e - s)
        self.total = total

    def _upto(self, x):
        i = bisect.bisect_right(self.starts, x) - 1
        if i < 0:
            return 0
        return self.before[i] + min(x, self.ends[i]) - self.starts[i]

    def busy(self, a, b):
        return self._upto(b) - self._upto(a)

    def idle(self, a, b):
        return (b - a) - self.busy(a, b)


def named(spans, names):
    return [s for s in spans if s[2] in names]


def idle_share(run, names):
    """The share (%) of the named spans' time in which the device was idle,
    or None where the run has no such span."""
    spans = recorded(run)
    if spans is None:
        return None
    chosen = named(spans, names)
    length = sum(s[4] - s[3] for s in chosen)
    if not length:
        return None
    busy = Busy(run["trace"]["device_ops"])
    return 100.0 * sum(busy.idle(s[3], s[4]) for s in chosen) / length


def ops_per_attr(run, name, attr):
    """The device operations that start inside the spans called `name`,
    over the sum of those spans' `attr`; None where there is no such span."""
    spans = recorded(run)
    if spans is None:
        return None
    chosen = sorted((s[3], s[4]) for s in named(spans, (name,)))
    count = sum(s[5].get(attr, 0) for s in named(spans, (name,)))
    if not chosen or not count:
        return None
    starts = [s for s, _ in chosen]
    inside = 0
    for _, s, _ in run["trace"]["device_ops"]:
        i = bisect.bisect_right(starts, s) - 1
        inside += i >= 0 and s <= chosen[i][1]
    return inside / count


def seconds_per_traced_unit(run, names):
    """The named spans' seconds, summed, over the traced units; None where
    the run has no such span."""
    spans = recorded(run)
    traced = [u for u in run["units"] if u.get("traced")]
    if spans is None or not traced:
        return None
    chosen = named(spans, names)
    if not chosen:
        return None
    return sum(s[4] - s[3] for s in chosen) * 1e-9 / len(traced)


def idle_by_innermost(spans, busy):
    """Idle seconds of the device by the innermost span the host was in: each
    span's idle time less its children's ({name: seconds}), and the idle time
    in no span under "(no span)", over [busy.lo, busy.hi] and the spans."""
    idle = {s[0]: busy.idle(s[3], s[4]) for s in spans}
    ids = set(idle)
    own = dict(idle)
    for s in spans:
        if s[1] in ids:
            own[s[1]] -= idle[s[0]]
    out = {}
    for s in spans:
        out[s[2]] = out.get(s[2], 0.0) + own[s[0]] * 1e-9
    lo = min([busy.lo] + [s[3] for s in spans])
    hi = max([busy.hi] + [s[4] for s in spans])
    top = [s for s in spans if s[1] not in ids]
    out["(no span)"] = (busy.idle(lo, hi) - sum(idle[s[0]] for s in top)) * 1e-9
    return out


def covered_share(spans, busy, roots=ROOTS):
    """The share (%) of the device's idle time, over [busy.lo, busy.hi] and
    the spans, that the spans below the unit's root cover (every span where
    the program opens no root)."""
    below = sorted((s[3], s[4]) for s in spans if s[2] not in roots)
    covered = 0
    end = None
    for s, e in below:  # the idle time inside the union of the spans
        if end is not None and s < end:
            s = end
        if e > s:
            covered += busy.idle(s, e)
            end = e
    lo = min([busy.lo] + [s[3] for s in spans])
    hi = max([busy.hi] + [s[4] for s in spans])
    total = busy.idle(lo, hi)
    return 100.0 * covered / total if total else None


def span_cost(n=20000):
    """Microseconds a span costs on this host, without and with a profiler
    recording (an empty block; the CPU profiler)."""
    import torch

    from sat_bundleadjust_tpu_torch.utils import profiling

    def per_span():
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    def empty():
        t0 = time.perf_counter()
        for _ in range(n):
            pass
        return (time.perf_counter() - t0) / n * 1e6

    off = per_span() - empty()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = per_span() - empty()
    profiling.reset()
    return {"off_us": off, "on_us": on}


def _report(run, workload):
    spans = recorded(run) or []
    traced = [u for u in run["units"] if u.get("traced")]
    untraced = sorted(u["wall_s"] for u in run["units"] if not u.get("traced"))
    busy = Busy(run["trace"]["device_ops"])
    by_name = {}
    for s in spans:
        by_name[s[2]] = by_name.get(s[2], 0) + 1
    idle = idle_by_innermost(spans, busy)
    attrs = {}
    for s in spans:  # the counters kept as attributes, summed by span name
        for k, v in s[5].items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                attrs.setdefault(s[2], {}).setdefault(k, 0)
                attrs[s[2]][k] += v
    return {
        "workload": workload,
        "traced_units": len(traced),
        "traced_unit_s": [u["wall_s"] for u in traced],
        "untraced_median_s": untraced[len(untraced) // 2] if untraced else None,
        "window_s": run["trace"]["window_s"], "busy_s": run["trace"]["busy_s"],
        "idle_s": run["trace"]["window_s"] - run["trace"]["busy_s"],
        "idle_from_first_to_last_s": sum(idle.values()),
        "spans_per_unit": len(spans) / max(len(traced), 1),
        "span_count": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
        "idle_by_innermost_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "idle_covered_below_root_pct": covered_share(spans, busy),
        "span_seconds": {name: sum(s[4] - s[3] for s in spans if s[2] == name) * 1e-9
                         for name in by_name},
        "span_attrs": attrs,
        "span_cost_us": span_cost(),
    }


def main(argv=None):
    from portbench import run as runm
    from portbench import spec as specm

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    class Kept(specm.Spec):
        """The benchmark's spec, keeping what its readers were given."""

        def reader(self, metric):
            read = super().reader(metric)

            def keep(run):
                self.run_rec = run
                return read(run)

            return keep

    spec = Kept()
    result = runm.run(args.workload, args.seed, args.seconds, 1, spec=spec)
    report = _report(spec.run_rec, args.workload)
    report["result"] = result
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in ("workload", "spans_per_unit",
                                             "idle_covered_below_root_pct")}), flush=True)


if __name__ == "__main__":
    main()
