"""The readings that a cell's limits are set from, in one process.

    python3 -m portbench.readings --workload <cell> --seeds <n> [<n> ...]
        [--faults <name> ...] [--out FILE]

For each seed: the cell's inputs, one unit of the program at the cell's own
size and those the driver runs after a window, the check of each answer
(the lower readings: sound runs of the program), the control in the
program's place (the upper readings), and one more unit under each fault of
portbench/faults.py named, judged alike. Each seed's readings are one JSON
line on standard output, and `--out` appends each line to a file as it
comes. Run it on the card; with the CPU it runs only where the cell's
configuration is small enough.
"""

import argparse
import json
import time


def readings(workload, seeds, device, spec=None, fault_names=()):
    import pytest

    from portbench import faults
    from portbench import spec as specm

    spec = spec or specm.Spec()
    cell = spec.cell(workload)
    driver = cell["driver"]
    for seed in seeds:
        t0 = time.perf_counter()
        units = driver.make(cell["config"], seed, device)
        try:
            rec = units(0)
            after = getattr(units, "after_window", None)
            judged = [rec] + (after() if after else [])
            program = driver.check(units, judged)
            control = driver.control(units, judged)
            planted = {}
            for k, name in enumerate(fault_names, 1):
                try:
                    with pytest.MonkeyPatch.context() as mp:
                        getattr(faults, name)(mp)
                        broken = units(k)
                    planted[name] = driver.check(units, [broken])[0]
                except Exception as e:  # a fault that crashes gives no number
                    planted[name] = "{}: {}".format(type(e).__name__, e)
        finally:
            close = getattr(units, "close", None)
            if close:
                close()
        yield {"workload": workload, "seed": seed, "program": program, "control": control,
               "faults": planted, "unit_s": rec["wall_s"], "seconds": time.perf_counter() - t0}


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for row in readings(args.workload, args.seeds, device, fault_names=args.faults):
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
