"""Run one cell of the port's benchmark once and print its result.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. The cell, its configuration, its traffic
driver and its metrics are found by name (``harness/spec.py``). A run:
clears every ``F16_*`` variable (the program's defaults are measured),
checks for the card, sets the cell up (``setup_s``), measures for
``--seconds`` seconds, reads the device's peak memory, frees the
program's state, compares a sample of the window's answers with the
plain reference (``correct``), and prints one JSON line last on standard
output. ``--trace 0`` reports the cell's end-to-end metrics; ``--trace
1`` traces a stretch of the window and reports its per-layer metrics.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Packages a run may not hold: JAX, and the JAX package the port mirrors.
FORBIDDEN = ("jax", "jaxlib", "flax", "flake16_framework_tpu")


def clean_env(env=os.environ):
    """Drop every ``F16_*`` knob, and keep libraries from loading JAX."""
    for k in [k for k in env if k.startswith("F16_")]:
        del env[k]
    env["USE_FLAX"] = "0"
    env["USE_JAX"] = "0"


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is a forbidden package."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Run:
    """What a driver is given: the cell, the seed, the device and a
    scratch directory under ``TMPDIR``."""

    def __init__(self, cell, seed, device, tmpdir):
        self.cell = cell
        self.config = cell.config
        self.params = cell.workload.get("params", {})
        self.seed = seed
        self.device = device
        self.tmpdir = tmpdir


def device_info(device, chips):
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def execute(args, *, root=ROOT, device=None, t_start=None, log=sys.stderr):
    """One run; returns the result dict. ``device`` None means the card:
    the run refuses to go on without one. Tests pass ``cpu`` and a root
    of their own."""
    import tempfile

    from port_bench.harness import spec

    t_start = T_START if t_start is None else t_start
    cell = spec.load_cell(args.workload, root=root)
    chips = int(cell.entry.get("chips", 1))
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise SystemExit(f"port_bench: the cell needs {chips} CUDA "
                             f"device(s); this machine has "
                             f"{torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
        torch.cuda.init()
    device = torch.device(device)
    driver = spec.load_module("traffic", cell.workload["driver"],
                              cell.bench_dir)
    readers = {m["name"]: spec.load_module("metrics", m["name"],
                                           cell.bench_dir)
               for m in (cell.per_layer if args.trace else cell.end_to_end)}
    hooks = [h for r in readers.values() for h in getattr(r, "HOOKS", ())]

    from port_bench.harness.tracer import Tracer

    with tempfile.TemporaryDirectory(prefix="port_bench-") as tmp:
        run = Run(cell, args.seed, device, tmp)
        state = driver.setup(run)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        tracer = Tracer(bool(args.trace), hooks, device)
        record = driver.window(state, args.seconds, tracer)
        tracer.stop()
        found = forbidden_modules()
        if found:
            raise SystemExit(f"port_bench: the run loaded {found}")
        dev = device_info(device, chips)
        record.update(setup_s=setup_s, peak_bytes=dev["memory_peak_bytes"])
        ctx = dict(record=record, tracer=tracer, state=state, run=run,
                   device=device)
        metrics = {}
        if args.trace:
            from port_bench.harness import timeline

            t0, t1 = timeline.window(tracer.events)
            busy = timeline.busy_ns(tracer.events, t0, t1)
            dev.update(busy_s=busy / 1e9, window_s=(t1 - t0) / 1e9)
            ctx.update(t0=t0, t1=t1, busy_ns=busy)
        for m in (cell.per_layer if args.trace else cell.end_to_end):
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = None
        if args.trace:
            breakdown = {
                "device_ops": timeline.top_device_ops(tracer.events, t0, t1),
                "idle_gaps": timeline.top_idle_gaps(tracer.events, t0, t1)}
        driver.release(state)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = driver.check(state, record)
    correct = bool(checks) and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    out = {"correct": correct, "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["extra"] = record.get("extra", {})
    out["checks"] = checks
    return out


def main(argv=None):
    clean_env()
    args = parse(argv)
    out = execute(args)
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
