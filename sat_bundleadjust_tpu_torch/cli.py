"""Command line interface of the port.

    python -m sat_bundleadjust_tpu_torch.cli config.json [--timeline] [--verbose]

The arguments of the JAX package's `bundle_adjust` (`cli.py`): one json
scene config, `--timeline` to list the acquisition dates and exit, and
`--verbose` to print to stdout instead of <output_dir>/bundle_adjust.log.
It runs on the CUDA card and raises where CUDA is not available; from
Python, `sat_bundleadjust_tpu_torch.main(config, device="cpu")` runs the
same chain on the CPU.

Several processes (one per card): start the same command in each, with
SATBA_COORDINATOR, SATBA_NUM_PROCESSES and SATBA_PROCESS_ID set, or under
torchrun; `parallel.multihost.initialize()` joins them before any work, and
the config's "distributed" key routes the solve over them. Each process
logs to its own file: bundle_adjust.log for rank 0, bundle_adjust.p<rank>.log
for the others.
"""

import argparse
import os
import sys


def main(argv=None):
    """Parse argv (default: sys.argv[1:]) and run the scene on the card.
    Returns the Scene (None with --timeline)."""
    parser = argparse.ArgumentParser(
        description="Bundle adjustment for RPC model refinement of satellite imagery (PyTorch, CUDA)")
    parser.add_argument("config", metavar="config.json", help="path to a json scene configuration file")
    parser.add_argument("--timeline", action="store_true",
                        help="print the timeline of the scene described by the config and exit")
    parser.add_argument("--verbose", action="store_true",
                        help="print to stdout instead of redirecting to output_dir/bundle_adjust.log")
    args = parser.parse_args(argv)

    from sat_bundleadjust_tpu_torch import resolve_device
    from sat_bundleadjust_tpu_torch.parallel import multihost
    from sat_bundleadjust_tpu_torch.parallel.mesh import world_rank
    from sat_bundleadjust_tpu_torch.timeseries import Scene
    from sat_bundleadjust_tpu_torch.utils import profiling
    from sat_bundleadjust_tpu_torch.utils.io import load_dict_from_json

    # several processes: join the process group (and pin this rank's card)
    # before any work; a no-op for one process
    multihost.initialize()
    device = resolve_device()
    if args.timeline:
        scene = Scene(args.config, device=device)
        scene.get_timeline_attributes(range(len(scene.timeline)), ["datetime", "n_images", "id"])
        return None

    # the whole run is one span, and with SATBA_PROFILE_DIR set one Chrome
    # trace of the program's spans and the card's work
    with profiling.device_trace("cli"), profiling.span("cli.main"):
        if args.verbose:
            scene = Scene(args.config, device=device)
            scene.run_bundle_adjustment_for_RPC_refinement()
            return scene

        out_dir = load_dict_from_json(args.config)["output_dir"]
        os.makedirs(out_dir, exist_ok=True)
        rank = world_rank()
        log_path = os.path.join(out_dir, "bundle_adjust.log" if rank == 0
                                else "bundle_adjust.p{}.log".format(rank))
        print("Running bundle adjustment; log at {}".format(log_path))
        stdout, stderr = sys.stdout, sys.stderr
        with open(log_path, "w") as log_file:
            sys.stdout = sys.stderr = log_file
            try:
                scene = Scene(args.config, device=device)
                scene.run_bundle_adjustment_for_RPC_refinement()
            finally:
                sys.stdout, sys.stderr = stdout, stderr
        return scene


if __name__ == "__main__":
    main()
