"""Measures what the audit's recorder (``analysis/ir.py``) costs and
changes on one NVIDIA GPU, at the audit's shape (the synthetic dataset of
``analysis/ir.audit_data``, n = 120, 2 trees, depth 8, 16 explained):
the whole grid through the plan executor (``SweepEngine(planner_mode=
True).run_grid``) and through ``pipeline.shap_grid`` in path mode, each
run bare and then under the recorder (deterministic mode included). The
recorded run's scores must equal the bare run's and its SHAP values must
be the bare run's bit for bit; the walls give the recorder's cost an
aten op.

Run from the repository root: ``python3 measure_audit.py``. Prints the
card's name and power limit, and one JSON object as its last line (also
written to ``chiprun_out/measure_audit.json``); exits 1 when a recorded
result differs from the bare one or without a CUDA device.
"""

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N, TREES, DEPTH, EXPLAIN = 120, 2, 8, 16


def main():
    if not torch.cuda.is_available():
        print("measure_audit: no CUDA device", file=sys.stderr)
        return 1
    os.environ["F16_PERFDB"] = "0"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    from flake16_framework_tpu_torch import config as cfg, pipeline
    from flake16_framework_tpu_torch.analysis import ir
    from flake16_framework_tpu_torch.kernels import build
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    build.build("hist_cumsum", "treeshap_unit")
    dev = torch.device("cuda")
    data = ir.audit_data(N)
    trees = {"Random Forest": TREES, "Extra Trees": TREES}
    keys = [tuple(k) for k in cfg.iter_config_keys()]

    def scores(configs):
        return SweepEngine(*data, max_depth=DEPTH, tree_overrides=trees,
                           device=dev, planner_mode=True).run_grid(configs)

    def shap():
        return pipeline.shap_grid(
            mode="path", n_explain=EXPLAIN, max_depth=DEPTH,
            tree_overrides=trees, configs=keys, arrays=data[:2],
            device=dev, progress_out=io.StringIO())

    scores(keys[:2])  # warm: kernel libraries, allocator
    walls = {}
    t0 = time.time()
    bare_scores = scores(keys)
    walls["scores_bare_s"] = time.time() - t0
    t0 = time.time()
    bare_values = shap()
    walls["shap_bare_s"] = time.time() - t0
    t0 = time.time()
    recs, opened, rec_scores = ir.trace_plan_program(
        keys, data, device=dev, max_depth=DEPTH, tree_overrides=trees)
    walls["scores_recorded_s"] = time.time() - t0
    t0 = time.time()
    srecs, sopened, rec_values = ir.trace_shap_plan_program(
        keys, data, device=dev, n_explain=EXPLAIN, max_depth=DEPTH,
        tree_overrides=trees)
    walls["shap_recorded_s"] = time.time() - t0

    ops = {"scores": sum(r["aten_ops"] for r in recs),
           "shap": sum(r["aten_ops"] for r in srecs)}
    scores_equal = all(bare_scores[k][2:] == rec_scores[k][2:]
                       for k in keys)
    values_bitwise = all(np.array_equal(bare_values[k], rec_values[k])
                         for k in bare_values)
    flagged = sorted({k for r in recs + srecs for k in r["nondet"]})
    out = {
        "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "configs": len(keys),
        "plan_windows": {"scores": opened, "shap": sopened},
        "aten_ops": ops, **{k: round(v, 3) for k, v in walls.items()},
        "recorder_us_per_op": {
            arm: round(1e6 * (walls[f"{arm}_recorded_s"]
                              - walls[f"{arm}_bare_s"]) / ops[arm], 2)
            for arm in ("scores", "shap")},
        "scores_equal": scores_equal, "shap_bitwise": values_bitwise,
        "flagged_ops": flagged,
    }
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "measure_audit.json"), "w") as fd:
        json.dump(out, fd, indent=1)
    print(json.dumps(out), flush=True)
    return 0 if scores_equal and values_bitwise else 1


if __name__ == "__main__":
    sys.exit(main())
