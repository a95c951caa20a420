"""Measures, on one NVIDIA GPU, what the plan executor's memory envelope
(``flake16_framework_tpu_torch/parallel/envelope.py``) stands on:

1. the device memory that library calls take beside their outputs (the
   CUDA sort's, ``argmin``'s, ``searchsorted``'s, the scans' and the
   SVD's workspaces, and the cuBLAS workspace that the process keeps
   after its first matrix product), at the shapes the ``scores`` path
   gives them and around them. No tensor of the port names these bytes,
   so the envelope carries them as measured constants;
2. each member of ``chip_smoke.py``'s ``planner_path`` (the RF, the ET
   and the two Decision Trees at N = 4000, 100 trees, depth 48, width
   128): its peak allocated bytes over the allocation at its entry, by
   phase (the resample of each fold, the bootstrap, the draws, the rest
   of the grower, predict, the counts), beside the envelope's own
   phases and its peak.

Run from the repository root: ``python3 measure_envelope.py``. Prints the
card's name and power limit, and one JSON object as its last line (also
written to ``chiprun_out/measure_envelope.json``); exits 1 without a CUDA
device or when the envelope is below a member's measured peak.
"""

import contextlib
import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

N, TREES, DEPTH, WIDTH, PROJECTS = 4000, 100, 48, 128, 26
MEMBERS = (
    ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
    ("OD", "Flake16", "PCA", "SMOTE Tomek", "Extra Trees"),
    ("NOD", "Flake16", "Scaling", "SMOTE", "Decision Tree"),
    ("OD", "Flake16", "PCA", "SMOTE Tomek", "Decision Tree"),
)


def _sync():
    torch.cuda.synchronize()


def transient(fn):
    """(bytes allocated beside the inputs and outputs at the call's peak,
    bytes the call left allocated): ``fn()``'s peak over the allocation
    after it returned, and that allocation over the one before."""
    _sync()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    _sync()
    after = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    del out
    return peak - after, after - before


def calibrate():
    """The library calls' workspaces, by call and shape: bytes beside the
    inputs and outputs, and those bytes an element of the input."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def rand(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=gen, device=dev).to(dtype)

    def put(name, fn, numel):
        extra, kept = transient(fn)
        rows[name] = {"workspace_bytes": extra, "kept_bytes": kept,
                      "numel": numel, "bytes_per_element": extra / numel}

    # The first matrix product of the process: cuBLAS keeps its workspace.
    a = rand(8000, 16)
    put("mm_first 8000x16 @ 16x8000", lambda: a @ a.T, 8000 * 8000)
    put("mm 8000x16 @ 16x8000", lambda: a @ a.T, 8000 * 8000)
    for m in (120, 240, 1000, 2000, 4000, 4097, 5000, 8000, 12000):
        d = rand(m, m)
        put(f"sort stable f32 [{m}, {m}] dim 1",
            lambda d=d: torch.sort(d, dim=1, stable=True), m * m)
        put(f"argmin f32 [{m}, {m}] dim 1",
            lambda d=d: torch.argmin(d, dim=1), m * m)
        del d
    for shape in ((10, 1, 16, 240), (10, 1, 16, 8000), (10, 1, 7, 8000),
                  (2, 100, 16, 8000), (2, 100, 7, 8000), (1, 1, 7, 8000),
                  (2, 1, 16, 8000), (10, 1, 7, 16000), (127, 8000),
                  (128, 8000), (26, 1, 16, 8000), (26, 1, 7, 8000),
                  (1, 1, 1, 4097), (10, 1, 7, 5000)):
        s = (rand(*shape) * shape[-1]).to(torch.int64)
        numel = int(np.prod(shape))
        put(f"sort stable i64 {list(shape)} dim -1",
            lambda s=s: torch.sort(s, dim=-1, stable=True), numel)
        f = rand(*shape)
        put(f"cumsum f32 {list(shape)} dim -1",
            lambda f=f: torch.cumsum(f, -1), numel)
        put(f"cummax f32 {list(shape)} dim -1",
            lambda f=f: torch.cummax(f, -1), numel)
        put(f"cummin f32 {list(shape)} dim -1",
            lambda f=f: torch.cummin(f, -1), numel)
        del s, f
    for shape in ((10, 16, 240), (10, 16, 8000), (10, 7, 8000)):
        f = rand(*shape)
        put(f"argsort stable f32 {list(shape)} dim -1",
            lambda f=f: torch.argsort(f, dim=-1, stable=True),
            int(np.prod(shape)))
    for shape in ((60, 16), (240, 16), (4000, 16), (4000, 7), (8000, 16),
                  (16000, 16), (5000, 7)):
        f = rand(*shape)
        put(f"sort stable f32 {list(shape)} dim 0",
            lambda f=f: torch.sort(f, dim=0, stable=True),
            int(np.prod(shape)))
        put(f"svd f32 {list(shape)}",
            lambda f=f: torch.linalg.svd(f, full_matrices=False),
            int(np.prod(shape)))
    for shape in ((20, 128, 16), (1000, 128, 16), (10, 1, 8000, 16),
                  (2, 100, 8000, 16), (1000, 128, 7)):
        f = rand(*shape)
        put(f"sort f32 {list(shape)} dim -1",
            lambda f=f: torch.sort(f, dim=-1), int(np.prod(shape)))
    for n in (4000, 8000):
        b = (rand(n) > 0.5).to(torch.int8)
        put(f"sort stable i8 [{n}]",
            lambda b=b: torch.sort(b, stable=True), n)
    cdf = torch.cumsum(rand(10, 8000), -1)
    u = rand(10, 800000) * cdf[:, -1:]
    put("searchsorted [10, 8000] <- [10, 800000]",
        lambda: torch.searchsorted(cdf, u, right=True), 10 * 800000)
    csum = torch.cumsum((rand(1000, 128) > 0.5).to(torch.int64), 1)
    q = torch.arange(256, device=dev).expand(1000, -1).contiguous()
    put("searchsorted [1000, 128] <- [1000, 256]",
        lambda: torch.searchsorted(csum, q), 1000 * 256)
    t = (rand(10, 16, 8000) * 64).to(torch.uint8)
    fi = (rand(1000, 8000) * 16).to(torch.int64)
    gix = torch.arange(10, device=dev)[:, None, None]
    six = torch.arange(8000, device=dev)[None, :]
    put("index [10, 16, 8000] at [10,1,1] x [10,100,8000] x [1,8000]",
        lambda: t[gix, fi.view(10, 100, 8000), six], 1000 * 8000)
    put("index [16, 8000] at [1000, 8000] x [1,8000]",
        lambda: t[0][fi, six], 1000 * 8000)
    big = rand(1000, 16, 128, 63)
    flags = big > 0.5
    put("any bool [1000, 16, 128, 63] dim -1",
        lambda: flags.any(-1), big.numel())
    put("sum bool [1000, 16, 128, 63] dim -1",
        lambda: flags.sum(-1), big.numel())
    put("sum bool [10, 8000, 16, 63] dim -1",
        lambda: flags.view(-1)[:10 * 8000 * 16 * 63].view(
            10, 8000, 16, 63).sum(-1), 10 * 8000 * 16 * 63)
    put("sum bool [1000, 128] dim 1",
        lambda: flags[:, 0, :, 0].sum(1), 1000 * 128)
    put("argmax f32 [1000, 16, 128, 63] dim -1",
        lambda: torch.argmax(big, -1), big.numel())
    put("argmax f32 [1000, 16, 128] dim 1",
        lambda: torch.argmax(big[..., 0], 1), 1000 * 16 * 128)
    tgt = torch.full((10, 1, 16, 8001), -torch.inf, device=dev)
    src = rand(10, 1, 16, 8000)
    idx = (rand(10, 1, 16, 8000) * 8000).to(torch.int64)
    put("scatter_reduce amax [10,1,16,8001] <- [10,1,16,8000]",
        lambda: tgt.scatter_reduce_(-1, idx, src, "amax"), src.numel())
    return rows


@contextlib.contextmanager
def phases(targets):
    """Attributes the allocator's peak to phases: each wrapped function
    (``targets``: [(module, name, phase)]) ends the phase it was called in
    and starts its own; the peak of a phase is the allocator's peak while
    it ran, over ``base[0]`` (the allocation at the member's entry)."""
    stack, peaks, base = ["member"], {}, [0]

    def mark():
        _sync()
        top = stack[-1]
        peaks[top] = max(peaks.get(top, 0),
                         torch.cuda.max_memory_allocated() - base[0])
        torch.cuda.reset_peak_memory_stats()

    def wrap(real, phase):
        @functools.wraps(real)
        def run(*args, **kwargs):
            mark()
            stack.append(phase)
            try:
                return real(*args, **kwargs)
            finally:
                mark()
                stack.pop()
        return run

    saved = []
    for mod, name, phase in targets:
        real = getattr(mod, name)
        saved.append((mod, name, real))
        setattr(mod, name, wrap(real, phase))
    try:
        yield peaks, base, mark
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def members():
    """Each member's measured peak by phase, beside the envelope's."""
    from flake16_framework_tpu_torch.analysis.ir import audit_data
    from flake16_framework_tpu_torch.ops import trees
    from flake16_framework_tpu_torch.parallel import planner, sweep

    data = audit_data(N, PROJECTS)
    engine = sweep.SweepEngine(*data, max_depth=DEPTH, device="cuda",
                               planner_mode=True)
    targets = [(sweep, "resample", "resample"),
               (trees, "bootstrap_weights", "bootstrap"),
               (trees, "_node_uniforms", "draws"),
               (trees, "_grow_trees", "grow"),
               (trees, "cum_hists", "k1"),
               (trees, "_proxy_score", "proxy"),
               (trees, "_fma", "fma"),
               (trees, "_select_features", "select"),
               (trees, "_emit_children", "emit"),
               (trees, "_window_update", "window"),
               (trees, "_fit_trees_exact", "grow"),
               (trees, "predict_batch", "predict"),
               (sweep, "confusion_by_fold", "counts")]
    out = []
    for keys in MEMBERS:
        plan = planner.plan_grid([keys], n=N, n_folds=engine.n_folds)[0]
        grow_kw = {"node_batch": WIDTH} \
            if trees.hist_tier_default(plan.shape[2]) else {}
        law = sweep.plan_envelope(plan, grow_kw, n_projects=PROJECTS,
                                  max_depth=DEPTH, grower=None,
                                  device_type="cuda", detail=True)
        with phases(targets) as (peaks, base, mark):
            _sync()
            base[0] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            engine._fit_count_folds(keys, **grow_kw)
            mark()
        peak = max(peaks.values())
        member = law["peak_bytes"] - law["arg_bytes"]
        out.append({"config": "/".join(keys), "entry_bytes": base[0],
                    "measured_bytes": peak, "law_bytes": member,
                    "ratio": member / peak, "measured_phases": dict(peaks),
                    "law_phases": law["phases"]})
        print(f"{'/'.join(keys)}: measured {peak / 1e9:.4f} GB over "
              f"{base[0] / 1e9:.4f} GB at entry, law {member / 1e9:.4f} "
              f"GB, law / measured {member / peak:.4f}", flush=True)
        for name in sorted(set(peaks) | set(law["phases"])):
            print(f"    {name:<10} measured {peaks.get(name, 0) / 1e6:>11.2f}"
                  f" MB  law {law['phases'].get(name, 0) / 1e6:>11.2f} MB",
                  flush=True)
        torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        print("measure_envelope: no CUDA device", file=sys.stderr)
        return 1
    os.environ["F16_PERFDB"] = "0"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    from flake16_framework_tpu_torch.kernels import build

    build.build("hist_cumsum")
    cal = calibrate()
    for name, r in cal.items():
        print(f"{name}: workspace {r['workspace_bytes']} B "
              f"({r['bytes_per_element']:.3f} B an element), kept "
              f"{r['kept_bytes']} B", flush=True)
    torch.cuda.empty_cache()
    rows = members() if "--calibrate-only" not in sys.argv else []
    report = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "calibration": cal,
              "members": rows}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "measure_envelope.json"),
              "w") as fd:
        json.dump(report, fd, indent=1)
    ok = all(r["ratio"] >= 1.0 for r in rows)
    print(json.dumps({"ok": ok, "ratios": {r["config"]: round(r["ratio"], 4)
                                           for r in rows}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
