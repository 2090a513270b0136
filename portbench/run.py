"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs from the seed, loads the program and warms
it up on the window's shapes (one unit). The window then runs whole units
back to back for `--seconds` (portbench/window.py). After it: the units
that the driver runs after the window (a problem of the seed's own), the
peak device memory, the check that no module of JAX or of the JAX package
was loaded, and the comparison of every unit's answer with the plain
reference (the cell's limits in portbench/limits/). The last line of standard output
is one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error and the last key of that object; sizes, peak
memory, unit walls and counts are on a line before it.

With --trace 1 the profiler records the first `trace_units` units of the
window (the traffic file) and the line carries the per-layer metrics, each
read by portbench/metrics/<name>.py, with `busy_s`, `window_s` and the
breakdown; with --trace 0 it carries the end-to-end metrics.
"""

import argparse
import json
import math
import os
import sys
import time


def process_start():
    """The wall-clock time at which this process started."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")


FORBIDDEN = ("jax", "jaxlib", "flax", "sat_bundleadjust_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (names compared whole: sat_bundleadjust_tpu_torch is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def judge(numbers, limits):
    """(failed units, worst {name: value} over units). A limit is {"max": x}
    or {"min": x}; a number past its limit, or not finite, fails its unit."""
    def ok(v, lim):
        return math.isfinite(v) and (v <= lim["max"] if "max" in lim else v >= lim["min"])

    nan = float("nan")
    values = {k: [nan if u is None else u.get(k, nan) for u in numbers] for k in limits}
    failed = sum(any(not ok(values[k][i], lim) for k, lim in limits.items())
                 for i in range(len(numbers)))
    worst = {k: nan if not v or not all(map(math.isfinite, v))
             else (max(v) if "max" in limits[k] else min(v)) for k, v in values.items()}
    return failed, worst


def run(workload, seed, seconds, trace, spec=None, device=None, t_start=None):
    """The run's result object. device: None for the CUDA card; tests pass
    the CPU here, which skips the look for a card and every device reading."""
    import torch

    from portbench import spec as specm
    from portbench import window
    from portbench.trace import Trace

    t_start = time.time() if t_start is None else t_start
    spec = spec or specm.Spec()
    cell = spec.cell(workload)
    on_card = device is None
    if on_card:
        chips = cell["workload"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit("portbench: this cell needs {} CUDA card(s); found {}".format(
                chips, torch.cuda.device_count() if torch.cuda.is_available() else 0))
        device = torch.device("cuda", 0)
    driver, traffic = cell["driver"], cell["traffic"]
    units = driver.make(cell["config"], seed, device)
    try:
        units(-1)  # the warm-up: every shape of the window
        n_traced = traffic["trace_units"] if trace else 0
        tracer = Trace(device) if n_traced else None

        def step(i):
            if i == 0 and tracer:
                tracer.__enter__()
            rec = units(i)
            rec["traced"] = i < n_traced
            if tracer and i == n_traced - 1:
                tracer.__exit__(None, None, None)
            return rec

        setup_s = time.time() - t_start
        records, start, ends = window.closed_loop(step, seconds)
        if tracer and len(records) < n_traced:
            tracer.__exit__(None, None, None)
        after = getattr(units, "after_window", None)
        judged = records + (after() if after else [])
        device_info = {"platform": "gpu", "kind": None, "count": cell["workload"]["chips"],
                       "memory_peak_bytes": None}
        if on_card:
            device_info.update(kind=torch.cuda.get_device_name(device),
                               memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))
        found = forbidden_modules()
        if found:
            raise SystemExit("portbench: modules loaded that the port must not load: "
                             + ", ".join(found))
        traced = tracer.summary() if tracer else None
        walls = sorted(r["wall_s"] for r in records)
        print("portbench " + json.dumps(dict(
            workload=workload, seed=seed, sizes=units.sizes,
            memory_peak_bytes=device_info["memory_peak_bytes"],
            unit_s=[r["wall_s"] for r in records],
            median_unit_s=walls[len(walls) // 2], **driver.describe(records))), flush=True)

        try:
            numbers = driver.check(units, judged)
        except Exception as e:  # a unit's outputs that cannot be read fail the run
            print("portbench: the check raised {}: {}".format(type(e).__name__, e), file=sys.stderr)
            numbers = [None] * len(judged)
        failed, worst = judge(numbers, cell["limits"])
    finally:
        close = getattr(units, "close", None)
        if close:
            close()

    out_metrics = {}
    if trace:
        run_rec = {"units": records, "trace": traced}
        for m in cell["per_layer"]:
            v = spec.reader(m["name"])(run_rec)
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
    else:
        per_unit = window.seconds_per_unit(start, ends)
        for m in cell["end_to_end"]:
            value = {"setup_s": setup_s, traffic["unit_metric"]: per_unit}[m["name"]]
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": failed == 0 and len(records) > 0, "attempted": len(judged),
              "failed": failed, "metrics": out_metrics, "device": device_info}
    if trace:
        result["breakdown"] = traced["breakdown"]
    result["checks"] = {k: dict(value=worst[k] if math.isfinite(worst[k]) else None, **lim)
                        for k, lim in cell["limits"].items()}
    sys.stdout.flush()
    for k, c in result["checks"].items():
        side = "max" if "max" in c else "min"
        print("check {} {!r} {} {!r}".format(k, c["value"], side, c[side]), file=sys.stderr)
    return result


def main(argv=None):
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run(args.workload, args.seed, args.seconds, args.trace, t_start=t_start)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
