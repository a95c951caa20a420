"""A checkout of the benchmark at a size a CPU test holds: BENCHMARK.json
and port_bench/ copied under a temporary root, each configuration cut
(tests, trees, depth) and each workload's traffic shortened, and one run
of a cell there on the CPU (``run.execute`` without the card check)."""

import json
import os
import shutil
import time

from port_bench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SIZES = {"n_tests": 240, "n_estimators": 4, "max_depth": 6}


def _edit(path, fn):
    with open(path) as fd:
        doc = json.load(fd)
    fn(doc)
    with open(path, "w") as fd:
        json.dump(doc, fd, indent=1)


def make_root(tmp, sizes=None, clients=3, check_requests=12):
    """A tiny checkout under ``tmp``; returns its root."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    bench = os.path.join(root, "port_bench")
    for name in os.listdir(os.path.join(bench, "configs")):
        _edit(os.path.join(bench, "configs", name),
              lambda c: c.update(sizes or SIZES))

    def study(w):
        w["params"]["axes"]["balancing"] = ["None", "SMOTE"]
        w["params"]["trace"] = {"from": 1, "count": 2}

    def serve(w):
        w["params"].update(clients=clients)
        w["params"]["check"]["requests"] = check_requests
        w["params"]["trace"] = {"at": 0.5, "seconds": 0.5}

    for name in os.listdir(os.path.join(bench, "workloads")):
        _edit(os.path.join(bench, "workloads", name),
              study if name.startswith("study") else serve)
    return root


def execute(root, workload, seed=7, seconds=1.5, trace=0):
    run.clean_env()
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    return run.execute(args, root=root, device="cpu",
                       t_start=time.perf_counter())
