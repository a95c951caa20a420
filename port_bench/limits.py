"""The readings a cell's limits are set from (steps 4 and 5 of how
``correct`` is decided): for each seed, one process sets the cell up,
runs a short window at the cell's own load, and prints the numbers the
run compares, read from the program (the lower readings) and from the
control, the reference computed in the precision below the
configuration's and put in the program's place (the upper readings).

    python3 port_bench/limits.py --workload <cell> --seconds <s>
        --seeds 1,2,3 [--control-seeds 1,2,3]

One JSON line a seed. Not part of a benchmark run."""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    from port_bench import run as bench

    bench.clean_env()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from port_bench.harness import spec
    from port_bench.harness.tracer import Tracer

    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    driver = spec.load_module("traffic", cell.workload["driver"],
                              cell.bench_dir)
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="port_bench-") as tmp:
            state = driver.setup(bench.Run(cell, seed, device, tmp))
            record = driver.window(state, args.seconds, Tracer(False))
            driver.release(state)
            torch.cuda.empty_cache()
            line = {"seed": seed, "attempted": record["attempted"],
                    "failed": record["failed"],
                    "program": {k: c["value"] for k, c in
                                driver.check(state, record).items()}}
            if seed in control_seeds:
                line["control"] = driver.control(state, record)
        line["wall_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
