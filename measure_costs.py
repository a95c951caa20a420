"""Measure on one card what the cost attribution and the executable store
cost (``obs/costs.py``, ``obs/aot.py``): the ``scores`` drill configs of
``chip_smoke.py`` (an RF, an ET and a Decision Tree at full width) run
with telemetry off, on, on, off in this process, each config's wall read
at its progress line, and each ``cost`` event's ``pass_s`` (its counted
call's wall); then the serving store warmed on those three models'
registry in this process, each capture split into its warm-up run and
its capture; then a child process's time to its first served request
(import, CUDA, registry load, warm), twice alone and once three at a
time (the fleet's start). Prints one JSON line a measurement and writes
``chiprun_out/measure_costs.json``.

Run from the repository root on the card: ``python3 measure_costs.py``.
It needs one CUDA device and exits non-zero without one.
"""

import io
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

CHILD = r"""
import sys, time
t0 = time.time()
import numpy as np, torch
from flake16_framework_tpu_torch.serve import ModelRegistry, ScoringService
t1 = time.time()
torch.zeros(1, device="cuda")
t2 = time.time()
reg = ModelRegistry(sys.argv[1])
reg.load()
t3 = time.time()
svc = ScoringService(reg, buckets=(8, 32, 128)).start()
t4 = time.time()
m = reg.models()[0]
svc.score(m.model_id, np.zeros((4, 16), np.float32)[:, :len(m.cols)],
          timeout=60)
t5 = time.time()
svc.stop()
print("TIMES", t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, flush=True)
"""


def main():
    if not torch.cuda.is_available():
        print("measure_costs: no CUDA device", file=sys.stderr)
        return 1
    os.environ["F16_PERFDB"] = "0"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    from chip_smoke import DRILL_CONFIGS, GRID_CONFIGS, N_PROJECTS, N_TESTS
    from flake16_framework_tpu_torch import obs
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.kernels import build
    from flake16_framework_tpu_torch.obs import aot, report
    from flake16_framework_tpu_torch.pipeline import write_scores
    from flake16_framework_tpu_torch.serve import ModelRegistry, ScoringService
    from flake16_framework_tpu_torch.utils.synth import make_tests_json

    build.build("hist_cumsum", "treeshap_unit")
    out = {"nvidia_smi": smi}
    with tempfile.TemporaryDirectory() as tmp:
        tj = os.path.join(tmp, "tests.json")
        make_tests_json(tj, n_tests=N_TESTS, n_projects=N_PROJECTS, seed=0)
        runs = []
        for i, mode in enumerate(("off", "on", "on", "off")):
            run_dir = None
            if mode == "on":
                run_dir = obs.configure(root=os.path.join(tmp, "tel"),
                                        heartbeat_s=0)
            walls, last = [], [time.time()]

            class Progress(io.StringIO):
                def write(self, s):
                    if s.startswith("["):
                        now = time.time()
                        walls.append(now - last[0])
                        last[0] = now
                    return super().write(s)

            try:
                last[0] = time.time()
                write_scores(tj, os.path.join(tmp, f"s{i}.pkl"),
                             max_depth=48, configs=list(DRILL_CONFIGS),
                             progress_out=Progress())
            finally:
                obs.shutdown()
            rec = {"telemetry": mode, "walls_s": walls}
            if run_dir is not None:
                _, events = report.load_run(run_dir)
                rec["pass_s"] = [(e["span"], e.get("pass_s"))
                                 for e in events if e["kind"] == "cost"]
            runs.append(rec)
            print(json.dumps(rec), flush=True)
        out["scores"] = runs

        feats, labels, _, _, _ = tests_to_arrays(load_tests(tj))
        root = os.path.join(tmp, "registry")
        registry = ModelRegistry(root)
        for keys in GRID_CONFIGS:
            registry.fit_and_register(keys, feats, labels, max_depth=48,
                                      seed=0)
        split = []
        real_new = aot.AotExecutableCache._new_graph
        real_capture = aot.cuda_graph_capture

        def timed_capture(fn, static_x):
            t0 = time.perf_counter()
            got = real_capture(fn, static_x)
            torch.cuda.synchronize()
            split[-1]["capture_s"] = time.perf_counter() - t0
            return got

        def timed_new(self, args, kwargs):
            split.append({"cache": self.name})
            t0 = time.perf_counter()
            graph = real_new(self, args, kwargs)
            torch.cuda.synchronize()
            split[-1]["total_s"] = time.perf_counter() - t0
            return graph

        aot.AotExecutableCache._new_graph = timed_new
        aot.cuda_graph_capture = timed_capture
        try:
            svc = ScoringService(registry, buckets=(8, 32, 128))
            for cache in svc.store._caches.values():
                cache._capture = timed_capture
            t0 = time.perf_counter()
            svc.start()
            warm_s = time.perf_counter() - t0
            svc.stop()
        finally:
            aot.AotExecutableCache._new_graph = real_new
            aot.cuda_graph_capture = real_capture
        out["warm"] = {"wall_s": warm_s, "graphs": split}
        print(json.dumps(out["warm"]), flush=True)

        children = []
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        for width in (1, 1, 3):
            t0 = time.time()
            procs = [subprocess.Popen(
                [sys.executable, "-c", CHILD, root], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for _ in range(width)]
            for proc in procs:
                stdout, stderr = proc.communicate(timeout=300)
                wall = time.time() - t0
                line = [ln for ln in stdout.splitlines()
                        if ln.startswith("TIMES")]
                if proc.returncode != 0 or not line:
                    print(stdout[-2000:], stderr[-4000:], file=sys.stderr)
                    return 1
                t = [float(v) for v in line[0].split()[1:]]
                children.append({"at_once": width, "wall_s": wall,
                                 "import_s": t[0], "cuda_init_s": t[1],
                                 "load_s": t[2], "warm_s": t[3],
                                 "first_request_s": t[4]})
                print(json.dumps(children[-1]), flush=True)
        out["children"] = children
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "measure_costs.json"), "w") as fd:
        json.dump(out, fd, indent=1)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
