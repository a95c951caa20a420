"""Measures the Tree SHAP unit kernel (``csrc/treeshap_unit.cu``) on one
NVIDIA GPU at the ``shap`` verb's full width (the two paper configs'
forests on the synthetic N = 4000 ``tests.json`` of ``chip_smoke.py``,
every cap bucket whole at S = 4000): the wrapper's own chunk size (work
items a block) against fixed ones, the wrapper's choice timed first and
last, every fixed chunk's result held against the wrapper's. It also
counts the opcodes of the built kernel (``cuobjdump -sass``).

Run from the repository root: ``python3 measure_treeshap_unit.py``. Prints
the card's name and power limit, the compiler's register and spill
report, and one JSON object as its last line (also written to
``chiprun_out/treeshap_unit_measure.json``).
"""

import collections
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

from chip_smoke import (F32_OPS_PER_S, N_PROJECTS, N_TESTS, SHAP_TOL,
                        _cuda_ms)
from flake16_framework_tpu_torch.kernels.treeshap_unit import (
    one_counts, unit_ops,
)

CHUNKS = (64, 128, 256, 512, 1024)


def sass_census(lib):
    """Static opcode counts of the kernels in shared library ``lib``, from
    ``cuobjdump -sass`` (predicates dropped, modifiers kept)."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump"),
         "-sass", str(lib)], capture_output=True, text=True, check=True,
        timeout=300).stdout
    ops = collections.Counter(
        m.group(1) for m in re.finditer(
            r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
            sass, re.M))
    return {"instructions": sum(ops.values()),
            "opcodes": dict(ops.most_common())}


def main():
    if not torch.cuda.is_available():
        print("measure_treeshap_unit: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    from flake16_framework_tpu_torch.config import SHAP_CONFIGS
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.kernels import build
    from flake16_framework_tpu_torch.kernels import treeshap_unit as tunit
    from flake16_framework_tpu_torch.ops.treeshap import bucket_inputs
    from flake16_framework_tpu_torch.pipeline import fit_shap_model
    from flake16_framework_tpu_torch.utils.synth import make_tests_json

    log = build.build("treeshap_unit")["treeshap_unit"]
    print(f"nvcc treeshap_unit: {log.strip()}", flush=True)
    census = sass_census(build._lib_path("treeshap_unit"))
    print(f"sass treeshap_unit: {json.dumps(census)}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        tj = os.path.join(tmp, "tests.json")
        make_tests_json(tj, n_tests=N_TESTS, n_projects=N_PROJECTS, seed=0)
        feats, labels, _, _, _ = tests_to_arrays(load_tests(tj))

    def run(args, x, chunk=None):
        saved = tunit.CHUNK, tunit.MIN_CHUNK
        if chunk is not None:
            tunit.CHUNK = tunit.MIN_CHUNK = chunk
        try:
            return tunit.unit_shap(*args, x)
        finally:
            tunit.CHUNK, tunit.MIN_CHUNK = saved

    rows = []
    for keys in SHAP_CONFIGS:
        xp, _, _, forest = fit_shap_model(keys, feats, labels)
        x = xp.contiguous()
        for cap, args in bucket_inputs(forest, x.shape[1]):
            ref = run(args, x)
            ref_max = float(ref.abs().max())
            err = 0.0
            for c in CHUNKS:
                err = max(err, float((run(args, x, c) - ref).abs().max()))
            if err > SHAP_TOL[0] * ref_max + SHAP_TOL[1]:
                raise AssertionError(f"{keys} cap {cap}: fixed chunks differ "
                                     f"by {err} (max {ref_max})")
            own = [_cuda_ms(lambda: run(args, x), reps=5, warm=1)]
            chunks = {c: _cuda_ms(lambda: run(args, x, c), reps=5, warm=1)
                      for c in CHUNKS}
            own.append(_cuda_ms(lambda: run(args, x), reps=5, warm=1))
            bound_ms = unit_ops(args[4], one_counts(*args, x),
                                x.shape[0]) / F32_OPS_PER_S * 1e3
            row = {"config": "/".join(keys), "cap": cap,
                   "paths": args[0].shape[0],
                   "mean_u": float(args[4].double().mean()),
                   "bound_ms": bound_ms, "chunks_max_abs_diff": err,
                   "own_chunk_ms": own, "chunk_ms": chunks}
            rows.append(row)
            print(json.dumps(row), flush=True)

    report = {"nvidia_smi": smi, "nvcc": log, "sass": census,
              "buckets": rows, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "treeshap_unit_measure.json"),
              "w") as fd:
        json.dump(report, fd, indent=1)
    print(json.dumps({"ok": True, "buckets": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
