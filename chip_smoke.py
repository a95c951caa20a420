"""Chip smoke of the PyTorch/CUDA port (flake16_framework_tpu_torch) on one
NVIDIA H100: builds the CUDA kernels from ``csrc/``, holds each against its
plain PyTorch version at the main path's shapes, drives the main paths at
full width (N = 4000 tests over 26 projects, 16 features, 100 trees,
depth 48) and checks what comes out: the ``scores`` verb (10 folds, 64
bins) on two ensemble configs (histogram grower) and two Decision Tree
configs (exact grower, which must launch no histogram kernel), ``scores
lopo`` (26 folds) on an ensemble and a Decision Tree config, and the
``shap`` verb on both paper configs. The histogram kernel is also held and
timed on the grower's real BFS steps: every step of the first fold's fit
of each ensemble ``scores`` config, recorded at full width. The exact
grower's fold-0 forest of the first Decision Tree config is held bitwise
against the CPU's and profiled alone, for its launches a level. The
ensemble configs and the first Decision Tree config then run once more
under the profiler, for the kernels' shares of device time.

The ``telemetry_path`` phase runs the scores path's four configs and
the ``shap`` verb on the paper configs once more, in a child process with
telemetry on (``F16_TELEMETRY``) and ``profile=``: its scores and SHAP
values must equal the untelemetered paths', every event and the manifest
be valid (backend ``cuda``, the card's name), ``report --json``,
``report --attrib`` and ``trace`` read the run, the fit and explain
spans' ``k1_launches``/``k2_launches`` sum to the wrappers' counts, and
each profile's CUDA kernel slices hold K1 and K2 as many times as the
wrappers counted. The four configs then run four more times here,
telemetry on, off, off, on, for telemetry's cost to the config walls.
The card's scaler is held bitwise against the CPU's in the small
reference.

``scores planner`` (the plan executor) runs the same four configs as
three plans, each member's 10 folds grown as one tree batch; its scores
must equal the scores path's, and each member's wall, K1 launches, host
reads, peak memory and (profiled once more) idle share are printed. K1 is
held bitwise and timed on every fold-batched BFS step of the RF member
(1,000 trees reading 10 groups of bins).

Three drills hold the crash tolerance of ``scores`` on the card, on an RF,
an ET and a Decision Tree config at full width, each against the scores
path's results: a kill drill (a SIGKILL right after the journal fsyncs
fold 4 of the ET config, in a child process under ``supervise``, which
dumps the child's flight ring, emits a ``restart`` event with telemetry
on, and restarts it to a journal replay and the uninterrupted run's
scores), a
real device-side assert in the second config's guarded run (quarantined
as ``deterministic``, exit 23, then a resume in a fresh process that
completes every config), and a real out-of-memory error retried once as
``oom`` before K1 runs bitwise.

The ``serve`` phase registers the grid phase's three models (ET and RF fit
through K1, a Decision Tree; seed 0) in the in-process scoring service,
warms it at buckets (8, 32, 128) and drives 1024 requests of 16 rows from
8 clients, predict and SHAP in turn (SHAP on K2 through the single-bucket
rows, one launch a microbatch); it holds each model, kind and bucket
against the direct call, K2 on the ET model's serving rows against its
plain version, times K2 at S = 8, 32 and 128, and runs the drain drill: the
``serve --hold`` verb in a child process, SIGTERM, its drain accounting,
and the flushed warm manifest against a reload in this process.

The fleet phases put the serve phase's persisted registry behind three
worker processes on the card (``serve --fleet 3``: each worker its own
CUDA context, loading the registry and warming with 9 K2 launches), the
router in front. ``fleet_path`` drives the same 1024-request load
through the router, reads each worker's ready time, memory and K2
launches (``stats``), and holds the fleet's answers for fixed rows against
the in-process store (predict bitwise, SHAP within SHAP_TOL, bitwise
reported). ``fleet_drill`` keeps 8 clients scoring through a second
fleet while worker 1 SIGKILLs itself as its fifth request arrives
(``F16_FAULT_INJECT=1:5:worker-kill``), then worker 0 is SIGKILLed from
here, then all three restart one at a time: zero client-visible errors,
the failover windows, the survivors' answers, the respawns' re-warm
launches and all-new pids.

``metrics_path`` runs the serve phase's service once more with its
Prometheus exporter (``metrics_port=0``), scraping ``/metrics`` every
0.5 s through the same load: every body valid, the last request count
the load's, device memory above 0; ``fleet_path`` scrapes the router's
federated endpoint the same way (3 workers up, series for workers 0-2).
``lockwatch_drill`` repeats the drain drill's child with the lock-order
witness armed (``F16_LOCKWATCH``): its dump validates, holds the locks the
port makes at import time and the serving locks, and has no cycle.
``perfdb_path`` points ``F16_PERFDB`` at a fresh database, ingests the
telemetry path's run (rows on ``cuda``, kernel rows with its launch
counts), runs ``scores planner`` under telemetry with the empty database
(K1 launches equal to the planner path's), records a plan padding and a
tuned window width (64) at the RF and ET plan shape and runs it again
(scores equal to the planner path's, more K1 launches at the narrower
window; K1 held bitwise against its plain version on every fold-batched
step at that width), diffs the two telemetry runs (``perf diff``), and
builds a service under a recorded bucket ladder, which warms exactly that
ladder (served values and K2 on the serving rows held at those sizes).
Every other phase runs with ``F16_PERFDB=0``.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device and exits non-zero without one. The last line of its output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels with
their launches on the main path, times and bounds. Details also go to
``chiprun_out/chip_smoke.json``.
"""

import contextlib
import io
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
SLEEP_CYCLES_PER_S = 2e9       # torch.cuda._sleep cycles, about the SM clock

SHAP_TOL = (1e-5, 1e-7)        # |a - b| <= rel * max|b| + abs
LOCAL_ACCURACY_TOL = 1e-5

MAIN_CONFIGS = (
    ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
    ("OD", "Flake16", "PCA", "SMOTE Tomek", "Extra Trees"),
)
DT_CONFIGS = (
    ("NOD", "Flake16", "Scaling", "SMOTE", "Decision Tree"),
    ("OD", "Flake16", "PCA", "SMOTE Tomek", "Decision Tree"),
)
LOPO_CONFIGS = (MAIN_CONFIGS[0], DT_CONFIGS[0])
# The whole-grid SHAP phase: the two paper SHAP configs (ET, RF) and a
# Decision Tree.
GRID_CONFIGS = (
    ("NOD", "Flake16", "Scaling", "SMOTE Tomek", "Extra Trees"),
    ("OD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
    DT_CONFIGS[0],
)
N_EXPLAIN, N_BACKGROUND = 64, 32
N_TESTS, N_PROJECTS, N_BINS, NODE_BATCH = 4000, 26, 64, 128


def _cuda_ms(fn, reps, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps, warm=2):
    """(device ms a call, host ms a call, queued) of ``fn``. The timed
    calls are queued behind a sleeping kernel that outlasts the host's
    enqueue of all of them, so the host's launch overhead is off the
    timed path; ``queued`` says whether the sleep did outlast it. The host
    time is that of an enqueue of ``reps`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * reps * SLEEP_CYCLES_PER_S) + 10 ** 6)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_s * 1e3, queued


def hist_bound_ms(rel, w, bin_t, n_nodes, n_bins):
    """K1's least time on the card for these inputs: each input read once
    ([T, N] int32 rel, f32 w and wy, [F, N] or [G, F, N] uint8 bins) and
    both [T, F, W, B] f32 outputs written once, over the memory rate,
    against the adds (two for each in-window sample of weight > 0 and
    feature, two an output element) over the f32 rate. Returns (ms,
    "bytes" or "operations")."""
    n_tree, n = rel.shape
    n_feat = bin_t.shape[-2]
    in_window = int(((rel >= 0) & (rel < n_nodes) & (w > 0)).sum())
    out_elems = n_tree * n_feat * n_nodes * n_bins
    nbytes = n_tree * n * 12 + bin_t.numel() + 2 * out_elems * 4
    ops = 2 * n_feat * in_window + 2 * out_elems
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def synthetic_hist_inputs():
    """K1's inputs at the full window: one fold's 100 trees, N = cap =
    8000, F = 16, B = 64, W = 128, integer bootstrap weights, and about
    80% of the samples in the window, so that all 128 rows are occupied."""
    n_tree, n, n_feat = 100, 2 * N_TESTS, 16
    rs = np.random.RandomState(0)
    w = rs.poisson(1.0, size=(n_tree, n)).astype(np.float32)
    w[:, int(0.9 * n):] = 0.0                      # invalid capacity slots
    y = (rs.rand(n) < 0.5).astype(np.float32)
    rel = rs.randint(-1, NODE_BATCH + NODE_BATCH // 4,
                     size=(n_tree, n)).astype(np.int32)
    bins = rs.randint(0, N_BINS, size=(n_feat, n)).astype(np.uint8)
    dev = torch.device("cuda")
    rel_t = torch.from_numpy(rel).to(dev)
    w_t = torch.from_numpy(w).to(dev)
    wy_t = w_t * torch.from_numpy(y).to(dev)
    bin_t = torch.from_numpy(bins).to(dev)
    return (rel_t, w_t, wy_t, bin_t, NODE_BATCH, N_BINS)


def check_hist_kernel():
    """K1 against its plain version at the synthetic full window
    (``synthetic_hist_inputs``). Bitwise equality is required, also
    between two runs."""
    from flake16_framework_tpu_torch.kernels.hist import (
        cum_hists, cum_hists_plain,
    )

    args = synthetic_hist_inputs()
    rel_t, w_t, wy_t, bin_t = args[:4]
    n_tree, n = rel_t.shape
    n_feat = bin_t.shape[0]
    dev = rel_t.device
    cw, cwy = cum_hists(*args)
    again = cum_hists(*args)
    pw, pwy = cum_hists_plain(*args)
    torch.cuda.synchronize()
    err = max(float((cw - pw).abs().max()), float((cwy - pwy).abs().max()))
    if not (torch.equal(cw, pw) and torch.equal(cwy, pwy)):
        raise AssertionError(f"hist_cumsum differs from cum_hists_plain: "
                             f"max abs err {err}")
    if not (torch.equal(cw, again[0]) and torch.equal(cwy, again[1])):
        raise AssertionError("hist_cumsum: two runs differ")
    del cw, cwy, again, pw, pwy

    ms = _cuda_ms(lambda: cum_hists(*args), reps=20)
    device_ms, host_ms, queued = _device_ms(lambda: cum_hists(*args),
                                            reps=20)
    plain_ms = _cuda_ms(lambda: cum_hists_plain(*args), reps=3, warm=1)
    # Library yardstick: the one-hot contraction as one einsum per class
    # on prebuilt f32 one-hots, plus the bin cumsum.
    member = (rel_t.long()[..., None] == torch.arange(NODE_BATCH, device=dev))
    ohw = member * w_t[..., None]
    ohwy = member * wy_t[..., None]
    ohfb = torch.nn.functional.one_hot(bin_t.long(), N_BINS).float()

    def library():
        return (torch.einsum("tnw,fnb->tfwb", ohw, ohfb).cumsum(-1),
                torch.einsum("tnw,fnb->tfwb", ohwy, ohfb).cumsum(-1))

    library_ms = _cuda_ms(library, reps=3, warm=1)
    del member, ohw, ohwy, ohfb

    bound_ms, bound_by = hist_bound_ms(rel_t, w_t, bin_t, NODE_BATCH, N_BINS)
    return {
        "name": "hist_cumsum", "route": "cuda",
        "source": "flake16_framework_tpu_torch/csrc/hist_cumsum.cu",
        "replaces": "flake16_framework_tpu/ops/trees.py:723",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "device_ms": device_ms,
        "host_ms_per_call": host_ms, "queued": queued,
        "shape": {"trees": n_tree, "n": n, "features": n_feat,
                  "window": NODE_BATCH, "bins": N_BINS},
    }


class _FoldZero(Exception):
    pass


def first_fold(engine, config, fit_name, run_fit=True):
    """The (args, kwargs) of fold 0's call of ``trees.<fit_name>`` in a
    ``SweepEngine`` run of ``config``, the run cut after that call (which
    runs unless ``run_fit`` is false)."""
    from flake16_framework_tpu_torch.ops import trees

    real = getattr(trees, fit_name)
    seen = []

    def cut(*args, **kwargs):
        seen.append((args, kwargs))
        if run_fit:
            real(*args, **kwargs)
        raise _FoldZero

    setattr(trees, fit_name, cut)
    try:
        engine.run_config(config)
    except _FoldZero:
        pass
    finally:
        setattr(trees, fit_name, real)
    return seen[0]


def record_steps(engine, config, fold_batched=False, **grow_kw):
    """K1's inputs at every BFS step of the first fold's fit of ``config``
    (a ``SweepEngine`` run cut after that fit), or with ``fold_batched``
    of the fold-batched fit of all its folds (the fused config's and the
    plan executor's, with the grower's keywords ``grow_kw``), as clones
    on the engine's device: [(rel, w, wy, bin_t, n_nodes, n_bins), ...].
    Wraps the grower's ``cum_hists`` for this call only."""
    from flake16_framework_tpu_torch.ops import trees

    steps = []
    real_cum_hists = trees.cum_hists

    def recorder(rel, w, wy, bin_t, n_nodes, n_bins):
        steps.append((rel.clone(), w.clone(), wy.clone(), bin_t.clone(),
                      n_nodes, n_bins))
        return real_cum_hists(rel, w, wy, bin_t, n_nodes, n_bins)

    trees.cum_hists = recorder
    try:
        if fold_batched:
            engine._fit_count_folds(config, **grow_kw)
        else:
            first_fold(engine, config, "fit_forest_hist")
    finally:
        trees.cum_hists = real_cum_hists
    return steps


def step_stats(rel, w, n_nodes):
    """(share of the live samples (w > 0) in the window, occupied window
    rows per tree [T]) of one recorded step."""
    live = w > 0
    inw = live & (rel >= 0) & (rel < n_nodes)
    share = float(inw.sum()) / max(1, int(live.sum()))
    occ = torch.zeros((rel.shape[0], n_nodes), device=rel.device)
    occ.scatter_add_(1, rel.clamp(0, n_nodes - 1).long(), inw.float())
    return share, (occ > 0).sum(1)


def launch_steps(steps):
    """K1 on each recorded step in turn, its outputs dropped."""
    from flake16_framework_tpu_torch.kernels.hist import cum_hists

    for s in steps:
        cum_hists(*s)


def check_real_steps(tests_file):
    """K1 on the grower's real BFS steps: every step of the first fold's
    fit of each ``scores`` config at full width, recorded by
    ``record_steps``. Each step's output must be bitwise equal to the
    plain version's and to a second run's. Times the kernel over all
    steps with CUDA events, launched back to back (``sum_ms``) and queued
    behind a sleep (``device_sum_ms``), against the sum of the steps' byte
    bounds, and summarises the steps' in-window shares and occupied
    rows."""
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.kernels.hist import (
        cum_hists, cum_hists_plain,
    )
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    engine = SweepEngine(*tests_to_arrays(load_tests(tests_file)))
    out = []
    for config in MAIN_CONFIGS:
        steps = record_steps(engine, config)
        per_step = []
        for s in steps:
            got, again = cum_hists(*s), cum_hists(*s)
            want = cum_hists_plain(*s)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"hist_cumsum differs from plain on a "
                                     f"real step of {config}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"hist_cumsum: two runs differ on a "
                                     f"real step of {config}")
            del got, again, want
            share, rows = step_stats(s[0], s[1], s[4])
            device_ms, _, queued = _device_ms(lambda: cum_hists(*s),
                                              reps=10)
            per_step.append({
                "ms": _cuda_ms(lambda: cum_hists(*s), reps=10),
                "device_ms": device_ms, "queued": queued,
                "bound_ms": hist_bound_ms(s[0], s[1], s[3], s[4], s[5])[0],
                "in_window_share": share,
                "rows_mean": float(rows.float().mean()),
                "rows_max": int(rows.max())})
        sum_ms = _cuda_ms(lambda: launch_steps(steps), reps=5)
        device_sum_ms, host_ms, queued = _device_ms(
            lambda: launch_steps(steps), reps=5)
        bound = sum(p["bound_ms"] for p in per_step)
        out.append({
            "config": "/".join(config), "steps": len(steps),
            "sum_ms": sum_ms, "mean_ms": sum_ms / len(steps),
            "device_sum_ms": device_sum_ms,
            "queued": queued and all(p["queued"] for p in per_step),
            "host_ms_per_call": host_ms / len(steps),
            "bound_sum_ms": bound, "bound_share": bound / sum_ms,
            "device_bound_share": bound / device_sum_ms,
            "in_window_share_mean": float(np.mean(
                [p["in_window_share"] for p in per_step])),
            "rows_mean": float(np.mean([p["rows_mean"] for p in per_step])),
            "steps_le_16_rows": sum(p["rows_mean"] <= 16 for p in per_step),
            "per_step": per_step})
        del steps
    return out


def one_counts(fid, z, lo, hi, u, scale, x):
    """Per work item, the number of (live slot, sample) pairs with o = 1,
    int64 [R], computed on the card in the plain version's row batches."""
    from flake16_framework_tpu_torch.kernels.treeshap_unit import PLAIN_ROWS

    cap = fid.shape[1]
    slots = torch.arange(cap, device=x.device)
    out = []
    for a in range(0, fid.shape[0], PLAIN_ROWS):
        b = slice(a, a + PLAIN_ROWS)
        x_sel = x.T[fid[b].long()]                              # [r, cap, S]
        o = (x_sel > lo[b, :, None]) & (x_sel <= hi[b, :, None])
        live = (slots < u[b, None])[..., None]
        out.append((o & live).sum((1, 2)))
    return torch.cat(out)


def unit_ops(u, n1, n_samples):
    """f32 flops (FMA = 2) that the kernel's division-free formulation
    needs for work items of live counts u [R] against ``n_samples``
    samples, with n1 [R] the (live slot, sample) pairs with o = 1 of each
    (``one_counts``). Per (work item, sample): 2u one-fraction compares;
    u^2 for EXTEND (step k: one multiply at position 0, an FMA at each of
    1..k, a select at k + 1); u + 1 multiplies back to the reference's
    weights; 2u for the shared o = 0 sum S0; 4u for each o = 1 slot's
    unwind (two FMAs a position); 2u for the contributions (a multiply and
    an add a slot): u^2 + 7u + 1 + 4u n1. Work per path that does not
    depend on the sample (the coefficients) is left out."""
    u, n1 = u.double(), n1.double()
    return float((u * u + 7.0 * u + 1.0).sum() * n_samples
                 + (4.0 * u * n1).sum())


def unit_ops_division(u, n_samples):
    """The bound of the division form this kernel replaced, kept for
    comparison: 9u^2 + 21u operations per (work item, sample), each add,
    multiply, compare and division counted as one."""
    u = u.double()
    return float((9.0 * u * u + 21.0 * u).sum()) * n_samples


def unit_report(members):
    """K2 against its plain version on every whole bucket of each member's
    forest, (keys, forest, x [S, F]) each, at the member's S. The plain
    version walks a bucket in row batches (``PLAIN_ROWS``) and sums them.
    Two kernel runs must be bitwise equal. ``ms`` and ``plain_ms`` are
    timed on the same inputs; the bound is the operations of these inputs
    (``unit_ops``) or their bytes, whichever is larger."""
    from flake16_framework_tpu_torch.kernels.treeshap_unit import (
        unit_shap, unit_shap_plain,
    )
    from flake16_framework_tpu_torch.ops.treeshap import bucket_inputs

    buckets = []
    for keys, forest, x in members:
        x = x.contiguous()
        for cap, args in bucket_inputs(forest, x.shape[1]):
            got = unit_shap(*args, x)
            again = unit_shap(*args, x)
            want = unit_shap_plain(*args, x)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"treeshap_unit cap {cap}: two runs "
                                     f"differ")
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"treeshap_unit cap {cap}: not finite")
            err = float((got - want).abs().max())
            ref = float(want.abs().max())
            if err > SHAP_TOL[0] * ref + SHAP_TOL[1]:
                raise AssertionError(f"treeshap_unit {keys} cap {cap} "
                                     f"differs from unit_shap_plain: {err} "
                                     f"(max {ref})")
            del got, again, want
            u = args[4]
            n1 = one_counts(*args, x)
            ops = unit_ops(u, n1, x.shape[0])
            ms = _cuda_ms(lambda: unit_shap(*args, x), reps=5, warm=1)
            buckets.append({
                "config": "/".join(keys), "cap": cap,
                "paths": args[0].shape[0],
                "mean_u": float(u.double().mean()),
                "o1_share": float(n1.sum()) / float(u.sum()) / x.shape[0],
                "max_abs_err": err, "max_abs_plain": ref,
                "ms": ms,
                "plain_ms": _cuda_ms(lambda: unit_shap_plain(*args, x),
                                     reps=1, warm=0),
                "ops": ops,
                "ops_division": unit_ops_division(u, x.shape[0]),
                "bound_share": ops / F32_OPS_PER_S * 1e3 / ms,
                "bytes": sum(a.numel() * 4 for a in args)
                + 2 * x.numel() * 4,
            })
    ops_ms = sum(b["ops"] for b in buckets) / F32_OPS_PER_S * 1e3
    bytes_ms = sum(b["bytes"] for b in buckets) / HBM_BYTES_PER_S * 1e3
    per_config = {}
    for b in buckets:
        c = per_config.setdefault(b["config"], {
            "ms": 0.0, "plain_ms": 0.0, "ops": 0.0, "ops_division": 0.0,
            "buckets": 0})
        for k in ("ms", "plain_ms", "ops", "ops_division"):
            c[k] += b[k]
        c["buckets"] += 1
    for c in per_config.values():
        c["bound_ms"] = c.pop("ops") / F32_OPS_PER_S * 1e3
        c["bound_ms_division"] = c.pop("ops_division") / F32_OPS_PER_S * 1e3
        c["bound_share"] = c["bound_ms"] / c["ms"]
    return {
        "name": "treeshap_unit", "route": "cuda",
        "source": "flake16_framework_tpu_torch/csrc/treeshap_unit.cu",
        "replaces": "flake16_framework_tpu/ops/treeshap.py:543",
        "max_abs_err": max(b["max_abs_err"] for b in buckets),
        "ms": sum(b["ms"] for b in buckets),
        "plain_ms": sum(b["plain_ms"] for b in buckets),
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_ms_division": sum(b["ops_division"] for b in buckets)
        / F32_OPS_PER_S * 1e3,
        "library_ms": None,
        "samples": members[0][2].shape[0], "per_config": per_config,
        "buckets": buckets,
    }


def check_unit_kernel(tests_file):
    """K2 on the real buckets of both full-width SHAP forests
    (``SHAP_CONFIGS``), every bucket whole at S = 4000: the ``shap``
    verb's shapes (``unit_report``)."""
    from flake16_framework_tpu_torch.config import SHAP_CONFIGS
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.pipeline import fit_shap_model

    feats, labels, _, _, _ = tests_to_arrays(load_tests(tests_file))
    members = []
    for keys in SHAP_CONFIGS:
        xp, _, _, forest = fit_shap_model(keys, feats, labels)
        members.append((keys, forest, xp))
    return unit_report(members)


def check_small_reference():
    """The card path against the port's CPU path on a small input: the
    same resampled data and keys grow bitwise-equal forests (the CPU path
    is held bitwise against the JAX package by the test suite), and a
    small sweep gives equal counts."""
    from flake16_framework_tpu_torch import rng
    from flake16_framework_tpu_torch.ops import trees
    from flake16_framework_tpu_torch.pipeline import (
        SHAP_MODES, shap_grid, write_scores, write_shap,
    )
    from flake16_framework_tpu_torch.utils.synth import (
        make_dataset, make_tests_json,
    )

    rs = np.random.RandomState(1)
    x = rs.randn(600, 16).astype(np.float32)
    y = (x[:, 0] - x[:, 3] + 0.5 * rs.randn(600)) > 1.0
    w = (rs.rand(600) > 0.2).astype(np.float32)
    out = {}
    for name, boot, rand in (("rf", True, False), ("et", False, True)):
        forests = []
        for dev in ("cpu", "cuda"):
            forests.append(trees.fit_forest_hist(
                torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
                torch.from_numpy(w).to(dev), rng.prng_key(5, dev),
                n_trees=8, bootstrap=boot, random_splits=rand,
                sqrt_features=True, max_depth=12))
        for fld in trees.Forest._fields[:-1]:
            a, b = getattr(forests[0], fld), getattr(forests[1], fld).cpu()
            if not torch.equal(a, b):
                raise AssertionError(f"{name} forest field {fld}: card "
                                     f"and CPU differ")
        out[name + "_forest_bitwise"] = True

    with tempfile.TemporaryDirectory() as d:
        tj = os.path.join(d, "tests.json")
        make_tests_json(tj, n_tests=400, n_projects=6, seed=2)
        cfgs = [("NOD", "Flake16", "None", "None", "Random Forest"),
                ("OD", "FlakeFlagger", "Scaling", "ENN", "Extra Trees")]
        kw = dict(max_depth=12, configs=cfgs, progress_out=io.StringIO(),
                  tree_overrides={"Random Forest": 8, "Extra Trees": 8})
        cpu = write_scores(tj, os.path.join(d, "c.pkl"), device="cpu", **kw)
        gpu = write_scores(tj, os.path.join(d, "g.pkl"), **kw)
    for k in cfgs:
        if cpu[k][2:] != gpu[k][2:]:
            raise AssertionError(f"{k}: card and CPU scores differ: "
                                 f"{gpu[k][3]} vs {cpu[k][3]}")
    out["small_scores_equal"] = len(cfgs)

    with tempfile.TemporaryDirectory() as d:
        tj = os.path.join(d, "tests.json")
        make_tests_json(tj, n_tests=400, n_projects=6, seed=2)
        kw = dict(max_depth=12,
                  tree_overrides={"Random Forest": 8, "Extra Trees": 8})
        cpu = write_shap(tj, os.path.join(d, "c.pkl"), device="cpu", **kw)
        gpu = write_shap(tj, os.path.join(d, "g.pkl"), **kw)
    errs = []
    for c, g in zip(cpu, gpu):
        err = float(np.abs(g["values"] - c["values"]).max())
        ref = float(np.abs(c["values"]).max())
        if err > SHAP_TOL[0] * ref + SHAP_TOL[1]:
            raise AssertionError(f"small write_shap: card and CPU differ "
                                 f"by {err} (max {ref})")
        errs.append(err)
    out["small_shap_max_abs_err"] = errs

    # The scaler sums in a fixed order of elementwise additions, so the
    # card's statistics are the CPU's bits: on the synthetic features at
    # full size and on random floats, Scaling's mu and W and PCA's mu.
    from flake16_framework_tpu_torch.ops.preprocess import fit_preprocess

    full, _, _ = make_dataset(n_tests=N_TESTS, n_projects=N_PROJECTS, seed=0)
    rs = np.random.RandomState(3)
    for x in (full.astype(np.float32), (rs.randn(N_TESTS, 16) * rs.uniform(
            0.1, 100, 16) + rs.uniform(-50, 50, 16)).astype(np.float32)):
        x = torch.from_numpy(x)
        for code in (1, 2):
            (mu_c, w_c), (mu_g, w_g) = (fit_preprocess(x, code),
                                        fit_preprocess(x.cuda(), code))
            _require(torch.equal(mu_c, mu_g.cpu()) and (
                code == 2 or torch.equal(w_c, w_g.cpu())),
                f"scaler (code {code}): card and CPU differ")
    out["scaler_card_equals_cpu"] = True

    # The grid's configs, scaled: given the same samples, the card and the
    # CPU grow the same forests, and the explainers are held on those.
    feats, labels, _ = make_dataset(n_tests=400, n_projects=6, seed=2)
    kw = dict(n_explain=64, n_background=32, max_depth=12,
              configs=list(GRID_CONFIGS), arrays=(feats, labels),
              progress_out=io.StringIO(),
              tree_overrides={"Random Forest": 8, "Extra Trees": 8})
    out["small_shap_grid_max_abs_err"] = {}
    for mode in SHAP_MODES:
        cpu = shap_grid(mode=mode, device="cpu", **kw)
        gpu = shap_grid(mode=mode, **kw)
        _require(list(gpu) == list(cpu), f"small shap_grid {mode}: keys")
        errs = []
        for name, c in cpu.items():
            g = gpu[name]
            err = float(np.abs(g - c).max())
            ref = float(np.abs(c).max())
            if err > SHAP_TOL[0] * ref + SHAP_TOL[1]:
                raise AssertionError(f"small shap_grid {mode} {name}: card "
                                     f"and CPU differ by {err} (max {ref})")
            if mode == "interaction":
                _require(np.array_equal(g, g.transpose(0, 2, 1)),
                         f"small shap_grid {name}: not symmetric")
            errs.append(err)
        out["small_shap_grid_max_abs_err"][mode] = max(errs)
    return out


def _require(cond, what):
    if not cond:
        raise AssertionError(what)


def _check_schema(scores, configs, n_projects):
    """The reference ``scores.pkl`` value schema, with consistent counts."""
    for k in configs:
        v = scores[k]
        _require(isinstance(v, list) and len(v) == 4, f"{k}: value {v!r}")
        t_train, t_test, per_proj, total = v
        _require(t_train > 0 and t_test >= 0, f"{k}: times {t_train} {t_test}")
        _require(len(per_proj) == n_projects, f"{k}: {len(per_proj)} projects")
        for row in per_proj.values():
            _require(len(row) == 6 and all(isinstance(c, int)
                                           for c in row[:3]), f"{k}: {row}")
        _require(len(total) == 6 and total[:3] == [
            sum(r[i] for r in per_proj.values()) for i in range(3)],
            f"{k}: total {total}")
        _require(sum(total[:3]) <= N_TESTS, f"{k}: total {total}")
        f1 = total[5]
        _require(f1 is None or 0.0 <= f1 <= 1.0, f"{k}: F1 {f1}")


def _reset_counts():
    from flake16_framework_tpu_torch.kernels.hist import cum_hists
    from flake16_framework_tpu_torch.kernels.treeshap_unit import unit_shap

    torch.cuda.synchronize()
    cum_hists.launches = 0
    unit_shap.launches = 0


def _read_counts():
    from flake16_framework_tpu_torch.kernels.hist import cum_hists
    from flake16_framework_tpu_torch.kernels.treeshap_unit import unit_shap

    torch.cuda.synchronize()
    return {"hist_cumsum": cum_hists.launches,
            "treeshap_unit": unit_shap.launches}


def _run_scores(tj, out_file, configs, **kw):
    """``write_scores`` on ``configs``, with the kernels' launch counts set
    to 0 just before and read just after. Returns (scores, launches, per
    config: its wall and its K1 launches), read at each progress line."""
    from flake16_framework_tpu_torch.kernels.hist import cum_hists
    from flake16_framework_tpu_torch.pipeline import write_scores

    walls, k1 = [], []
    last = [0.0]

    class Progress(io.StringIO):
        def write(self, s):
            if s.startswith("["):
                now = time.time()
                walls.append(now - last[0])
                k1.append(cum_hists.launches - sum(k1))
                last[0] = now
            return super().write(s)

    log = Progress()
    _reset_counts()
    last[0] = time.time()
    scores = write_scores(tj, out_file, max_depth=48, configs=list(configs),
                          progress_out=log, **kw)
    launches = _read_counts()
    return scores, launches, walls, k1, _journal_stats(log.getvalue())


def _journal_stats(text):
    """The journal's closing line of a ``write_scores`` log: {"n_appends",
    "append_wall_s", "sweep_wall_s", "append_share"}."""
    m = re.search(r"^journal: (\d+) appends in ([0-9.]+) s of ([0-9.]+) s$",
                  text, re.M)
    _require(m is not None, "no journal line in the log")
    n, append_s, wall_s = int(m[1]), float(m[2]), float(m[3])
    return {"n_appends": n, "append_wall_s": append_s,
            "sweep_wall_s": wall_s, "append_share": append_s / wall_s}


def _config_rows(scores, configs, walls, k1):
    return [{"config": "/".join(k), "wall_s": walls[i],
             "hist_cumsum_launches": k1[i],
             "t_train_per_fold_s": scores[k][0],
             "t_test_per_fold_s": scores[k][1],
             "counts_fp_fn_tp": scores[k][3][:3], "f1": scores[k][3][5]}
            for i, k in enumerate(configs)]


def run_scores_path(tmp, tj):
    """The scores verb at full width on the ensemble and Decision Tree
    configs, with the kernels' launch counts read around exactly this run:
    each ensemble config launches K1, no Decision Tree config does."""
    configs = MAIN_CONFIGS + DT_CONFIGS
    out_file = os.path.join(tmp, "scores.pkl")
    scores, launches, walls, k1, journal = _run_scores(tj, out_file, configs)
    for k, n in zip(configs, k1):
        tree = k[4] == "Decision Tree"
        if tree != (n == 0):
            raise AssertionError(f"{k}: {n} hist_cumsum launches")
    with open(out_file, "rb") as fd:
        on_disk = pickle.load(fd)
    _require(set(on_disk) == set(configs), f"keys {sorted(on_disk)}")
    _check_schema(on_disk, configs, N_PROJECTS)
    _require(not os.path.exists(out_file + ".journal"), "journal left")
    return launches, _config_rows(scores, configs, walls, k1), journal, \
        on_disk


def run_lopo_path(tmp, tj):
    """``scores lopo`` at full width on an ensemble and a Decision Tree
    config: one fold a project (26), written to ``scores-lopo.pkl``."""
    out_file = os.path.join(tmp, "scores-lopo.pkl")
    t0 = time.time()
    scores, launches, walls, k1, _ = _run_scores(tj, out_file, LOPO_CONFIGS,
                                                 cv="lopo")
    wall = time.time() - t0
    _require(k1[0] > 0 and k1[1] == 0, f"lopo hist_cumsum launches {k1}")
    with open(out_file, "rb") as fd:
        on_disk = pickle.load(fd)
    _require(set(on_disk) == set(LOPO_CONFIGS), f"keys {sorted(on_disk)}")
    _check_schema(on_disk, LOPO_CONFIGS, N_PROJECTS)
    return launches, _config_rows(scores, LOPO_CONFIGS, walls, k1), wall


# The telemetry phase's child: the scores path's four configs with
# telemetry on (``F16_TELEMETRY``) under ``profile=``, then the shap verb
# on the paper configs under a capture of its own. It prints each
# config's wall (at its progress line), the kernels' launch counts after
# each verb, and its run directory.
_TELEMETRY_CHILD = """
import io, json, sys, time, torch
from flake16_framework_tpu_torch import obs
from flake16_framework_tpu_torch.kernels.build import launch_counts
from flake16_framework_tpu_torch.pipeline import write_scores, write_shap
tests_file, out_dir, configs = sys.argv[1:4]
obs.configure_from_env()
walls, last = [], [time.time()]
class Progress(io.StringIO):
    def write(self, s):
        if s.startswith("["):
            walls.append(time.time() - last[0])
            last[0] = time.time()
        return super().write(s)
write_scores(tests_file, out_dir + "/scores.pkl", max_depth=48,
             configs=[tuple(k) for k in json.loads(configs)],
             progress_out=Progress(), profile_dir=out_dir + "/prof/scores")
print("scores launches: " + json.dumps(launch_counts()), flush=True)
print("walls: " + json.dumps(walls), flush=True)
with obs.profiler_trace(out_dir + "/prof/shap", torch.device("cuda")):
    write_shap(tests_file, out_dir + "/shap.pkl", max_depth=48)
print("all launches: " + json.dumps(launch_counts()), flush=True)
print("run: " + obs.current_run_dir(), flush=True)
"""


def _line_json(text, head):
    return json.loads(text.rsplit(head, 1)[1].splitlines()[0])


def _kernel_counts(summary):
    """K1's and K2's launches in a summarized device trace."""
    return {k: sum(n for name, n in summary["counts"].items() if k in name)
            for k in ("hist_cumsum", "treeshap_unit")}


def run_telemetry_path(tmp, tj, ref):
    """The scores path's four configs and the shap verb on the paper
    configs at full width, in a child process with telemetry on and
    ``profile=``: the scores equal the scores path's, every event and the
    manifest are valid (backend cuda, the card's name), ``report --json``
    (valid), ``report --attrib`` and ``trace`` read the run, the fit spans'
    ``k1_launches`` and the explain spans' ``k1``/``k2_launches`` sum to the
    child's counts, and each profile's CUDA kernel slices hold K1 and K2
    as many times as the wrappers counted. Returns the launches, the
    report, and the child's ``shap.pkl`` (held against the shap path's
    later in the run)."""
    from flake16_framework_tpu_torch.obs import report, schema, trace

    out_dir = os.path.join(tmp, "telemetry")
    os.makedirs(out_dir)
    configs = MAIN_CONFIGS + DT_CONFIGS
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)), F16_TELEMETRY=os.path.join(out_dir, "tel"))
    env.pop("F16_FAULT_INJECT", None)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-c", _TELEMETRY_CHILD, tj, out_dir,
         json.dumps(configs)], env=env, cwd=tmp, capture_output=True,
        text=True, timeout=900)
    child_s = time.time() - t0
    _require(proc.returncode == 0, f"telemetry child: exit "
             f"{proc.returncode}\n{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    text = proc.stdout
    scores_n = _line_json(text, "scores launches: ")
    all_n = _line_json(text, "all launches: ")
    walls = _line_json(text, "walls: ")
    run_dir = text.rsplit("run: ", 1)[1].splitlines()[0]
    with open(os.path.join(out_dir, "scores.pkl"), "rb") as fd:
        got = pickle.load(fd)
    _require(set(got) == set(configs), f"telemetry scores: {sorted(got)}")
    for k in configs:
        _require(pickle.dumps(got[k][2:]) == pickle.dumps(ref[k][2:]),
                 f"telemetry scores: {k} differs from the scores path")

    manifest, events = report.load_run(run_dir)
    bad = [p for e in events for p in schema.validate_event(e)]
    bad += schema.validate_manifest(manifest)
    _require(not bad, f"telemetry events: {bad[:5]}")
    kind = torch.cuda.get_device_name(0)
    _require(manifest.get("backend") == "cuda"
             and manifest.get("device_kind") == kind,
             f"telemetry manifest: {manifest.get('backend')} "
             f"{manifest.get('device_kind')}")
    buf = io.StringIO()
    rep = report.report_main([run_dir, "--json"], out=buf)
    _require(schema.validate_report(json.loads(buf.getvalue())) == [],
             "report --json invalid")
    attrib_text = io.StringIO()
    attrib = report.report_main([run_dir, "--attrib"], out=attrib_text)
    trace_path = trace.trace_main([run_dir], out=io.StringIO())
    with open(trace_path) as fd:
        xs = [e for e in json.load(fd)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e["kind"] == "span"]
    _require(len(xs) == len(spans), f"trace: {len(xs)} of {len(spans)}")

    def span_sum(name, field):
        return sum(e[field] for e in spans if e["name"] == name)

    shap_n = {k: all_n[k] - scores_n[k] for k in all_n}
    sums = {"scores.fit k1": span_sum("scores.fit", "k1_launches"),
            "shap.config k1": span_sum("shap.config", "k1_launches"),
            "shap.config k2": span_sum("shap.config", "k2_launches")}
    _require(sums["scores.fit k1"] == scores_n["k1_launches"] > 0
             and scores_n["k2_launches"] == 0
             and sums["shap.config k1"] == shap_n["k1_launches"] > 0
             and sums["shap.config k2"] == shap_n["k2_launches"] > 0,
             f"span launches {sums} against counted {scores_n} {shap_n}")
    profiles = {}
    for name, want in (("scores", scores_n), ("shap", shap_n)):
        summary = trace.summarize_device_trace(
            os.path.join(out_dir, "prof", name), out=io.StringIO())
        _require(summary is not None, f"no {name} profile trace")
        counts = _kernel_counts(summary)
        _require(counts == {"hist_cumsum": want["k1_launches"],
                            "treeshap_unit": want["k2_launches"]},
                 f"{name} profile: kernel slices {counts} against the "
                 f"wrappers' {want}")
        profiles[name] = {"trace": summary["trace"],
                          "trace_mb": os.path.getsize(summary["trace"]) / 1e6,
                          "kernel_slices": summary["slices"],
                          "device_s": summary["total_s"], **counts}
    _require(len([e for e in events if e["kind"] == "profile"]) == 2,
             "profile events")
    return {"hist_cumsum": all_n["k1_launches"],
            "treeshap_unit": all_n["k2_launches"]}, {
        "child_s": child_s, "run_dir": run_dir,
        "profiled_config_walls_s": dict(zip(
            ("/".join(k) for k in configs), walls)),
        "span_launches": sums, "profiles": profiles,
        "report_spans": {n: s["n"] for n, s in rep["spans"].items()},
        "report_counters": rep["counters"],
        "attrib_top": list(attrib["configs"])[:3],
        "attrib_launch_totals": attrib["kernel_launch_totals"],
        "attrib_text_lines": len(attrib_text.getvalue().splitlines()),
        "trace_events": len(xs)}, os.path.join(out_dir, "shap.pkl")


def time_telemetry(tmp, tj):
    """The scores path's four configs run four more times in this process,
    telemetry on, off, off, on (two pairs in turns): each config's wall
    (at its progress line) in each run, and each pair's on/off ratio of the
    configs' summed walls."""
    from flake16_framework_tpu_torch import obs

    configs = MAIN_CONFIGS + DT_CONFIGS
    runs = []
    for i, mode in enumerate(("on", "off", "off", "on")):
        if mode == "on":
            obs.configure(root=os.path.join(tmp, "telemetry-walls"))
        try:
            _, _, walls, _, _ = _run_scores(
                tj, os.path.join(tmp, f"walls-{i}.pkl"), configs)
        finally:
            obs.shutdown()
        runs.append({"telemetry": mode, "walls_s": dict(zip(
            ("/".join(k) for k in configs), walls)),
            "sum_s": sum(walls)})
    ratios = [runs[0]["sum_s"] / runs[1]["sum_s"],
              runs[3]["sum_s"] / runs[2]["sum_s"]]
    return {"runs": runs, "on_over_off": ratios}


def check_telemetry_shap(child_shap, shap_path_pkl):
    """The telemetry child's SHAP values against the shap path's, which
    ran without telemetry: bitwise, with the largest difference."""
    with open(child_shap, "rb") as fd:
        got = pickle.load(fd)
    with open(shap_path_pkl, "rb") as fd:
        want = pickle.load(fd)
    diffs = [float(np.abs(a - b).max()) for a, b in zip(got, want)]
    _require(len(got) == len(want) == 2 and all(
        a.tobytes() == b.tobytes() for a, b in zip(got, want)),
        f"telemetry SHAP values differ from the shap path's by {diffs}")
    return diffs


@contextlib.contextmanager
def _count_host_reads():
    """Counts, while open, the host's reads of CUDA tensors' values:
    ``bool()`` (the growers' loop conditions), ``.item()`` and ``.cpu()``
    (the counts). Yields a one-element list holding the count."""
    count = [0]
    own = {name: torch.Tensor.__dict__.get(name)
           for name in ("__bool__", "item", "cpu")}

    def counted(real):
        def read(self, *args, **kwargs):
            if self.is_cuda:
                count[0] += 1
            return real(self, *args, **kwargs)
        return read

    for name in own:
        setattr(torch.Tensor, name, counted(getattr(torch.Tensor, name)))
    try:
        yield count
    finally:
        for name, real in own.items():
            if real is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, real)


def run_planner_path(tmp, tj, ref):
    """``write_scores(planner=True)`` at full width over the scores path's
    configs: three plans (RF, ET, and the two Decision Trees), each
    member's 10 folds grown as one tree batch (1,000 trees on K1, or 10
    single trees on the exact grower). The pickle's scores must equal the
    scores path's (``ref``, v[2:] bitwise), each ensemble member must
    launch K1 and no Decision Tree member may, and the timing meta must
    mark every member combined and the two-member plan amortized. Per
    member (one ``SweepEngine._fit_count_folds`` call, synchronised): its
    wall, K1 launches, host reads (``_count_host_reads``) and peak
    allocated memory."""
    from flake16_framework_tpu_torch.kernels.hist import cum_hists
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    configs = MAIN_CONFIGS + DT_CONFIGS
    members = []
    real = SweepEngine._fit_count_folds

    def measured(self, keys):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1 = cum_hists.launches
        with _count_host_reads() as reads:
            t0 = time.perf_counter()
            out = real(self, keys)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        members.append({"config": "/".join(keys), "folds": self.n_folds,
                        "wall_s": wall,
                        "hist_cumsum_launches": cum_hists.launches - k1,
                        "host_reads": reads[0],
                        "peak_allocated_gb":
                            torch.cuda.max_memory_allocated() / 1e9})
        return out

    out_file = os.path.join(tmp, "scores-planner.pkl")
    SweepEngine._fit_count_folds = measured
    try:
        t0 = time.time()
        _, launches, _, _, journal = _run_scores(tj, out_file, configs,
                                                 planner=True)
        wall = time.time() - t0
    finally:
        SweepEngine._fit_count_folds = real
    with open(out_file, "rb") as fd:
        on_disk = pickle.load(fd)
    _require(set(on_disk) == set(configs), f"keys {sorted(on_disk)}")
    for k in configs:
        _require(pickle.dumps(on_disk[k][2:]) == pickle.dumps(ref[k][2:]),
                 f"planner path: {k} differs from the scores path")
    _require([m["config"] for m in members] == ["/".join(k) for k in (
        MAIN_CONFIGS[0], DT_CONFIGS[0], DT_CONFIGS[1], MAIN_CONFIGS[1])],
        f"planner path ran {[m['config'] for m in members]}")
    for m in members:
        tree = m["config"].endswith("Decision Tree")
        _require(tree == (m["hist_cumsum_launches"] == 0),
                 f"{m['config']}: {m['hist_cumsum_launches']} K1 launches")
    with open(out_file + ".meta.json") as fd:
        meta = json.load(fd)
    _require(meta["fused_combined"] == sorted(list(k) for k in configs)
             and meta["batch_amortized"] == sorted(list(k)
                                                   for k in DT_CONFIGS),
             f"timing meta {meta}")
    return launches, members, journal, wall


def check_batched_steps(tests_file):
    """K1 on every fold-batched BFS step of the RF member (its 10 folds'
    1,000 trees as one batch, each fold's trees reading that fold's bins):
    each step bitwise equal to the plain version's and to a second run's,
    the steps timed back to back (CUDA events) and queued behind a sleep
    against the sum of their byte bounds (the G x F x N bins included)."""
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.kernels.hist import (
        cum_hists, cum_hists_plain,
    )
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    config = MAIN_CONFIGS[0]
    engine = SweepEngine(*tests_to_arrays(load_tests(tests_file)))
    steps = record_steps(engine, config, fold_batched=True)
    bounds, shares, rows = [], [], []
    for s in steps:
        got, again = cum_hists(*s), cum_hists(*s)
        want = cum_hists_plain(*s)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"hist_cumsum differs from plain on a "
                                 f"fold-batched step of {config}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"hist_cumsum: two runs differ on a "
                                 f"fold-batched step of {config}")
        del got, again, want
        bounds.append(hist_bound_ms(s[0], s[1], s[3], s[4], s[5])[0])
        share, occ = step_stats(s[0], s[1], s[4])
        shares.append(share)
        rows.append(float(occ.float().mean()))
    sum_ms = _cuda_ms(lambda: launch_steps(steps), reps=3, warm=1)
    device_sum_ms, host_ms, queued = _device_ms(lambda: launch_steps(steps),
                                                reps=3, warm=1)
    return {"config": "/".join(config), "steps": len(steps),
            "trees": int(steps[0][0].shape[0]),
            "groups": int(steps[0][3].shape[0]),
            "sum_ms": sum_ms, "mean_ms": sum_ms / len(steps),
            "device_sum_ms": device_sum_ms, "queued": queued,
            "host_ms_per_call": host_ms / len(steps),
            "bound_sum_ms": sum(bounds), "bound_share": sum(bounds) / sum_ms,
            "device_bound_share": sum(bounds) / device_sum_ms,
            "in_window_share_mean": float(np.mean(shares)),
            "rows_mean": float(np.mean(rows))}


def profile_member(tests_file, config, wall_s):
    """One plan member's fold-batched fit (``_fit_count_folds`` over its
    10 folds) once more under the profiler, outside the counted path:
    launches, device busy time, K1's share, and the idle share of
    ``wall_s``, its unprofiled wall on the planner path."""
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    engine = SweepEngine(*tests_to_arrays(load_tests(tests_file)))
    kernels = _profiled(lambda: engine._fit_count_folds(config))
    busy_ms = sum(k[0] for k in kernels)
    hist_ms = sum(k[0] for k in kernels if "hist_cumsum" in k[1])
    return {"config": "/".join(config), "wall_s_unprofiled": wall_s,
            "kernel_launches": sum(k[2] for k in kernels),
            "device_busy_ms": busy_ms, "hist_cumsum_ms": hist_ms,
            "hist_cumsum_launches": sum(k[2] for k in kernels
                                        if "hist_cumsum" in k[1]),
            "hist_share_of_device": hist_ms / busy_ms if busy_ms else None,
            "device_idle_share": 1.0 - busy_ms / 1e3 / wall_s,
            "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                            for ms, n, c in kernels[:15]]}


def run_shap_path(tmp, tj):
    """The shap verb at full width on both paper configs, with the
    kernels' launch counts read around exactly this run. Checks the
    ``shap.pkl`` schema and local accuracy for every sample:
    |sum_f phi_f - (p0(x) - E[p0])| <= LOCAL_ACCURACY_TOL."""
    from flake16_framework_tpu_torch.config import SHAP_CONFIGS
    from flake16_framework_tpu_torch.ops.trees import predict_proba
    from flake16_framework_tpu_torch.ops.treeshap import expected_p0
    from flake16_framework_tpu_torch.pipeline import write_shap

    out_file = os.path.join(tmp, "shap.pkl")
    _reset_counts()
    t0 = time.time()
    results = write_shap(tj, out_file, max_depth=48)
    wall = time.time() - t0
    launches = _read_counts()
    if launches["treeshap_unit"] == 0:
        raise AssertionError("the shap path never launched treeshap_unit")
    with open(out_file, "rb") as fd:
        on_disk = pickle.load(fd)
    _require(isinstance(on_disk, list) and len(on_disk) == 2,
             f"shap.pkl holds {type(on_disk)}")
    res = []
    for keys, values, r in zip(SHAP_CONFIGS, on_disk, results):
        _require(values.dtype == np.float32
                 and values.shape == (N_TESTS, 16),
                 f"{keys}: {values.dtype} {values.shape}")
        _require(bool(np.isfinite(values).all()), f"{keys}: not finite")
        p0 = predict_proba(r["forest"], r["x"])[:, 0]
        gap = (p0 - expected_p0(r["forest"])).cpu().numpy()
        acc_err = float(np.abs(values.astype(np.float64).sum(1) - gap).max())
        _require(acc_err <= LOCAL_ACCURACY_TOL,
                 f"{keys}: local accuracy off by {acc_err}")
        res.append({"config": "/".join(keys), "fit_s": r["fit_s"],
                    "explain_s": r["explain_s"],
                    "local_accuracy_max_err": acc_err,
                    "max_abs_phi": float(np.abs(values).max()),
                    "n_nodes_max": int(r["forest"].n_nodes.max())})
    return launches, res, wall


@contextlib.contextmanager
def _recorded_members():
    """Keeps, while open, each result of ``pipeline.shap_for_config`` (the
    grid's members) with its peak allocated device memory. Yields the
    list of results."""
    from flake16_framework_tpu_torch import pipeline

    real = pipeline.shap_for_config
    kept = []

    def recorder(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = real(*args, **kwargs)
        torch.cuda.synchronize()
        kept.append(dict(res, keys=args[0], peak_allocated_gb=torch.cuda
                         .max_memory_allocated() / 1e9))
        return res

    pipeline.shap_for_config = recorder
    try:
        yield kept
    finally:
        pipeline.shap_for_config = real


def run_shap_grid_path(tmp, tj):
    """``pipeline.shap_grid`` at full width on ``GRID_CONFIGS`` in each of
    its three modes (``explain=64``, ``background=32``), with the kernels'
    launch counts set to 0 just before the three runs and read just
    after: each ensemble member's fit launches K1, the path mode K2.
    Checks each ``shap-<mode>.pkl`` (keys, f32, shapes, finite), the path
    mode's local accuracy (|sum_f phi_f - (p0(x) - E[p0])|), the
    interventional mode's (|sum_f phi_f - (p0(x) - mean_b p0(b))|), both
    within LOCAL_ACCURACY_TOL, and the interaction mode's bitwise
    symmetry and row sums (the same member's path values, within
    SHAP_TOL). Returns (launches, member rows, per-mode walls and
    launches, the path members as (keys, forest, x[:64]) for
    ``unit_report``)."""
    from flake16_framework_tpu_torch.ops.trees import predict_proba
    from flake16_framework_tpu_torch.ops.treeshap import expected_p0
    from flake16_framework_tpu_torch.pipeline import SHAP_MODES, shap_grid

    names = ["/".join(k) for k in GRID_CONFIGS]
    rows, modes, path = [], {}, {}
    _reset_counts()
    for mode in SHAP_MODES:
        out_file = os.path.join(tmp, f"shap-{mode}.pkl")
        before = _read_counts()
        t0 = time.time()
        with _recorded_members() as members:
            values = shap_grid(tj, out_file, mode=mode, n_explain=N_EXPLAIN,
                               n_background=N_BACKGROUND, max_depth=48,
                               configs=list(GRID_CONFIGS),
                               progress_out=io.StringIO())
        wall = time.time() - t0
        after = _read_counts()
        with open(out_file, "rb") as fd:
            on_disk = pickle.load(fd)
        _require(on_disk["mode"] == mode and on_disk["n_explain"] == N_EXPLAIN
                 and on_disk["n_background"] == (
                     N_BACKGROUND if mode == "interventional" else 0),
                 f"shap-{mode}.pkl header {on_disk['mode']} "
                 f"{on_disk['n_explain']} {on_disk['n_background']}")
        _require(sorted(on_disk["values"]) == sorted(names)
                 and list(values) == list(on_disk["values"]),
                 f"shap-{mode}.pkl keys {list(on_disk['values'])}")
        for m in members:
            name = "/".join(m["keys"])
            v = on_disk["values"][name]
            _require(np.array_equal(v, m["values"]), f"{name}: pickled "
                     f"values differ from the member's")
            f = m["x"].shape[1]
            shape = (N_EXPLAIN, f, f) if mode == "interaction" \
                else (N_EXPLAIN, f)
            _require(v.dtype == np.float32 and v.shape == shape,
                     f"{mode} {name}: {v.dtype} {v.shape}")
            _require(bool(np.isfinite(v).all()), f"{mode} {name}: not finite")
            x = m["x"][:N_EXPLAIN]
            p0 = predict_proba(m["forest"], x)[:, 0]
            row = {"mode": mode, "config": name, "fit_s": m["fit_s"],
                   "explain_s": m["explain_s"],
                   "peak_allocated_gb": m["peak_allocated_gb"],
                   "n_nodes_max": int(m["forest"].n_nodes.max()),
                   "max_abs_value": float(np.abs(v).max())}
            if mode == "path":
                gap = (p0 - expected_p0(m["forest"])).cpu().numpy()
                path[name] = (v, (m["keys"], m["forest"], x))
            elif mode == "interventional":
                base = predict_proba(m["forest"], m["x"][:N_BACKGROUND])[:, 0]
                gap = (p0 - base.mean()).cpu().numpy()
            if mode != "interaction":
                err = float(np.abs(v.astype(np.float64).sum(1) - gap).max())
                _require(err <= LOCAL_ACCURACY_TOL,
                         f"{mode} {name}: local accuracy off by {err}")
                row["local_accuracy_max_err"] = err
            else:
                _require(np.array_equal(v, v.transpose(0, 2, 1)),
                         f"interaction {name}: not symmetric")
                ref = path[name][0]
                err = float(np.abs(v.sum(2) - ref).max())
                _require(err <= SHAP_TOL[0] * float(np.abs(ref).max())
                         + SHAP_TOL[1], f"interaction {name}: row sums off "
                         f"the path values by {err}")
                row["row_sum_vs_path_max_err"] = err
            rows.append(row)
        modes[mode] = {"wall_s": wall, "launches": {
            k: after[k] - before[k] for k in after}}
    launches = _read_counts()
    _require(launches["hist_cumsum"] > 0 and launches["treeshap_unit"] > 0,
             f"shap_grid path launches {launches}")
    _require(modes["path"]["launches"]["treeshap_unit"]
             == launches["treeshap_unit"], "K2 launched outside path mode")
    return launches, rows, modes, [p[1] for p in path.values()]


def profile_explains(members):
    """Each ensemble member's explain in each mode (``x`` its first 64
    preprocessed samples, the interventional background their first 32)
    timed once unprofiled, after one warm run, and once more under the
    profiler: wall, launches, device busy time, idle share and the top
    kernels."""
    from flake16_framework_tpu_torch.ops import treeshap

    engines = {
        "path": treeshap.forest_shap_class0,
        "interventional": lambda f, x: treeshap.forest_shap_interventional(
            f, x, x[:N_BACKGROUND]),
        "interaction": treeshap.forest_shap_interactions,
    }
    out = []
    for keys, forest, x in members:
        if keys[4] == "Decision Tree":
            continue
        for mode, fn in engines.items():
            fn(forest, x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(forest, x)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            kernels = _profiled(lambda: fn(forest, x))
            busy_ms = sum(k[0] for k in kernels)
            out.append({"config": "/".join(keys), "mode": mode,
                        "wall_s": wall_s,
                        "kernel_launches": sum(k[2] for k in kernels),
                        "device_busy_ms": busy_ms,
                        "device_idle_share": 1.0 - busy_ms / 1e3 / wall_s,
                        "top_kernels": [{"name": n[:120], "ms": ms,
                                         "count": c}
                                        for ms, n, c in kernels[:8]]})
    return out


# The serve phase: the grid phase's three models (ET and RF fit through
# K1, a Decision Tree), seed 0, behind one service at the default buckets,
# under a closed-loop load of 1024 requests of 16 rows from 8 clients.
SERVE_BUCKETS = (8, 32, 128)
SERVE_REQUESTS, SERVE_ROWS, SERVE_CLIENTS = 1024, 16, 8


class _KindClock:
    """The service (or the fleet's router) as ``sustained_load`` drives
    it, with each request's wall on the client's side kept by kind, and,
    in one process, the store's dispatches counted by kind."""

    def __init__(self, svc):
        import threading

        self.svc = svc
        self.latency = svc.latency
        self.ms = {"predict": [], "shap": []}
        self.dispatches = {"predict": 0, "shap": 0}
        self._lock = threading.Lock()
        if not hasattr(svc, "store"):
            self.dispatches = {"predict": None, "shap": None}
            return
        real = svc.store.call

        def counted(model, kind, x):
            with self._lock:
                self.dispatches[kind] += 1
            return real(model, kind, x)

        svc.store.call = counted

    def stats(self):
        return self.svc.stats()

    def score(self, model_id, x, kind="predict", timeout=None):
        t0 = time.perf_counter()
        out = self.svc.score(model_id, x, kind=kind, timeout=timeout)
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.ms[kind].append(ms)
        return out

    def by_kind(self, wall_s):
        out = {}
        for kind, ms in self.ms.items():
            ms = sorted(ms)
            pct = (lambda p: ms[min(len(ms) - 1, round(p * (len(ms) - 1)))])
            out[kind] = {"requests": len(ms), "rps": len(ms) / wall_s,
                         "p50_ms": pct(0.50), "p99_ms": pct(0.99),
                         "dispatches": self.dispatches[kind]}
        return out


def run_serve_path(tmp, tj):
    """The ``serve`` verb's in-process service at full width: registers
    ``GRID_CONFIGS`` (seed 0, depth 48, 100 trees), warms it at
    ``SERVE_BUCKETS`` and drives ``sustained_load`` (1024 requests of 16
    rows, 8 clients, predict and SHAP in turn), with the kernels' launch
    counts set to 0 just before the registration and read just after the
    load: K1 from the ET and RF fits, K2 once a SHAP microbatch (and once
    a model and bucket at warm). Returns (launches, report, the service
    still running, the registry, the data)."""
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.serve import ModelRegistry, ScoringService
    from flake16_framework_tpu_torch.serve.cli import sustained_load

    feats, labels, _, _, _ = tests_to_arrays(load_tests(tj))
    registry = ModelRegistry(os.path.join(tmp, "serve-registry"))
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for keys in GRID_CONFIGS:
        registry.fit_and_register(keys, feats, labels, max_depth=48, seed=0)
    torch.cuda.synchronize()
    register_s = time.time() - t0
    registered = _read_counts()
    peak_register = torch.cuda.max_memory_allocated() / 1e9
    svc = ScoringService(registry, buckets=SERVE_BUCKETS)
    t0 = time.time()
    svc.start()
    warm_s = time.time() - t0
    warmed = _read_counts()
    clock = _KindClock(svc)
    torch.cuda.reset_peak_memory_stats()
    load = sustained_load(clock, feats, registry.ids(),
                          n_requests=SERVE_REQUESTS, rows=SERVE_ROWS,
                          kinds=("predict", "shap"), clients=SERVE_CLIENTS)
    launches = _read_counts()
    peak_load = torch.cuda.max_memory_allocated() / 1e9
    _require(load["n_errors"] == 0, f"serve load errors: {load['errors']}")
    _require(load["requests"] == SERVE_REQUESTS
             and load["completed"] == SERVE_REQUESTS,
             f"serve load completed {load['completed']} of "
             f"{load['requests']}")
    kinds = clock.by_kind(load["wall_s"])
    load_k2 = launches["treeshap_unit"] - warmed["treeshap_unit"]
    _require(registered["hist_cumsum"] > 0 and load_k2 > 0,
             f"serve path launches {launches}")
    _require(load_k2 == kinds["shap"]["dispatches"],
             f"K2 launched {load_k2} times for "
             f"{kinds['shap']['dispatches']} SHAP microbatches")
    _require(warmed["treeshap_unit"] == len(GRID_CONFIGS) * len(SERVE_BUCKETS),
             f"warm launches {warmed}")
    report = {
        "register_s": register_s, "warm_s": warm_s,
        "register_launches": registered, "warm_launches": warmed,
        "load_launches": {k: launches[k] - warmed[k] for k in launches},
        "peak_allocated_gb_register": peak_register,
        "peak_allocated_gb_load": peak_load,
        "load": load, "by_kind": kinds,
        "models": {m.model_id: {"n_nodes_max": int(m.forest.n_nodes.max()),
                                "node_slots": m.forest.feature.shape[1],
                                "trees": m.forest.feature.shape[0]}
                   for m in registry.models()},
    }
    return launches, report, svc, registry, feats


def check_served_values(svc, registry, feats, buckets=SERVE_BUCKETS):
    """Each model, kind and bucket size: the served result against the
    direct call on the same rows — predict (``trees.predict_proba`` on
    the transformed rows) within 1e-6 absolute, SHAP against the packed
    engine (``forest_shap_class0``) within SHAP_TOL, and the served SHAP
    values' local accuracy within LOCAL_ACCURACY_TOL."""
    from flake16_framework_tpu_torch.ops.preprocess import transform
    from flake16_framework_tpu_torch.ops.trees import predict_proba
    from flake16_framework_tpu_torch.ops.treeshap import (
        expected_p0, forest_shap_class0,
    )

    rows = []
    for model in registry.models():
        for bucket in buckets:
            x = feats[:bucket]
            xp = transform(torch.from_numpy(np.ascontiguousarray(
                x[:, list(model.cols)], dtype=np.float32)).cuda(),
                model.mu, model.wmat)
            pred = svc.score(model.model_id, x, kind="predict", timeout=120)
            phi = svc.score(model.model_id, x, kind="shap", timeout=120)
            p = predict_proba(model.forest, xp)
            pred_err = float(np.abs(pred - p.cpu().numpy()).max())
            _require(pred_err <= 1e-6, f"{model.model_id}@{bucket}: served "
                     f"predict off by {pred_err}")
            want = forest_shap_class0(model.forest, xp).cpu().numpy()
            shap_err = float(np.abs(phi - want).max())
            ref = float(np.abs(want).max())
            _require(shap_err <= SHAP_TOL[0] * ref + SHAP_TOL[1],
                     f"{model.model_id}@{bucket}: served SHAP off the "
                     f"packed engine by {shap_err} (max {ref})")
            gap = (p[:, 0] - expected_p0(model.forest)).cpu().numpy()
            acc_err = float(np.abs(phi.astype(np.float64).sum(1)
                                   - gap).max())
            _require(acc_err <= LOCAL_ACCURACY_TOL,
                     f"{model.model_id}@{bucket}: local accuracy off by "
                     f"{acc_err}")
            rows.append({"model": model.model_id, "bucket": bucket,
                         "predict_max_abs_err": pred_err,
                         "shap_max_abs_err": shap_err, "max_abs_phi": ref,
                         "local_accuracy_max_err": acc_err})
    return rows


def _serving_rows(registry, feats, keys, n_samples):
    """(``graph_inputs`` rows, transformed samples [n_samples, F]) of the
    registered model of ``keys``, on the card."""
    from flake16_framework_tpu_torch.ops.preprocess import transform
    from flake16_framework_tpu_torch.ops.treeshap import graph_inputs
    from flake16_framework_tpu_torch.serve import model_id_for

    model = registry.get(model_id_for(keys))
    rows = graph_inputs(model.forest, len(model.cols))
    xp = transform(torch.from_numpy(np.ascontiguousarray(
        feats[:n_samples, list(model.cols)], dtype=np.float32)).cuda(),
        model.mu, model.wmat)
    return rows, xp


def check_unit_rows(registry, feats, samples):
    """K2 on the ET model's single-bucket rows (``graph_inputs``) at each
    sample count of ``samples`` against ``unit_shap_plain`` (SHAP_TOL;
    two kernel runs bitwise). Returns one record a count."""
    from flake16_framework_tpu_torch.kernels.treeshap_unit import (
        unit_shap, unit_shap_plain,
    )

    keys = GRID_CONFIGS[0]
    rows, xp = _serving_rows(registry, feats, keys, max(samples))
    out = []
    for s in samples:
        x = xp[:s].contiguous()
        got, again = unit_shap(*rows, x), unit_shap(*rows, x)
        want = unit_shap_plain(*rows, x)
        torch.cuda.synchronize()
        _require(torch.equal(got, again), f"K2 serving rows at S = {s}: "
                 f"two runs differ")
        err = float((got - want).abs().max())
        ref = float(want.abs().max())
        _require(err <= SHAP_TOL[0] * ref + SHAP_TOL[1],
                 f"K2 on the ET serving rows at S = {s} differs from "
                 f"unit_shap_plain: {err} (max {ref})")
        out.append({"config": "/".join(keys), "samples": s,
                    "rows": rows[4].shape[0], "max_abs_err": err,
                    "max_abs_plain": ref})
    return out


def serve_unit_report(registry, feats):
    """K2 on the single-bucket rows (``graph_inputs``) of the ET and RF
    models at the serving buckets' sample counts: at S = 128 on the ET
    rows against ``unit_shap_plain`` (``check_unit_rows``), and its ms at
    S = 8, 32 and 128 on both (``_cuda_ms``) against the operation bound
    of these inputs (``unit_ops`` over the live rows) and their bytes."""
    from flake16_framework_tpu_torch.kernels.treeshap_unit import (
        unit_shap, unit_shap_plain,
    )

    out = {"check": check_unit_rows(registry, feats,
                                    (max(SERVE_BUCKETS),))[0],
           "timings": []}
    for keys in GRID_CONFIGS[:2]:
        rows, xp = _serving_rows(registry, feats, keys, max(SERVE_BUCKETS))
        u = rows[4]
        live = u > 0
        for s in SERVE_BUCKETS:
            x = xp[:s].contiguous()
            live_rows = tuple(t[live] for t in rows)
            ops = unit_ops(u[live], one_counts(*live_rows, x), s)
            ms = _cuda_ms(lambda: unit_shap(*rows, x), reps=20, warm=2)
            nbytes = sum(t.numel() * 4 for t in rows) + 2 * x.numel() * 4
            bound_ops = ops / F32_OPS_PER_S * 1e3
            bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            out["timings"].append({
                "config": "/".join(keys), "samples": s,
                "rows": u.shape[0], "live_rows": int(live.sum()),
                "mean_live_u": float(u[live].double().mean()),
                "ms": ms,
                "plain_ms": _cuda_ms(lambda: unit_shap_plain(*rows, x),
                                     reps=1, warm=0),
                "bound_ms": max(bound_ops, bound_bytes),
                "bound_by": "operations" if bound_ops >= bound_bytes
                else "bytes",
                "bound_share": max(bound_ops, bound_bytes) / ms})
    return out


# The drain drill's child: the ``serve`` verb held under its own load
# until SIGTERM, at full width, persisting its registry.
_DRAIN_ARGS = ["serve", "--hold", "--synth", str(N_TESTS), "--trees", "100",
               "--max-depth", "48", "--kinds", "predict,shap"]


def run_drain_drill(tmp, name="drill", env_extra=None):
    """``python -m flake16_framework_tpu_torch serve --hold ...`` as a
    child process (its registry ``<tmp>/<name>-registry``, ``env_extra``
    added to its environment): wait for SERVE_READY, let it serve a
    second, SIGTERM it and parse its DRAIN_ACCT line, which must show
    exit 0, phase ``complete`` and no failed and no rejected request.
    Then the parent reloads the child's registry: the flushed
    ``aot_manifest.json`` must equal the reloaded store's
    ``warm_manifest`` (the reload-warm contract)."""
    import signal
    import threading

    from flake16_framework_tpu_torch.serve import ExecutableStore, ModelRegistry
    from flake16_framework_tpu_torch.serve.store import MANIFEST_FILE

    reg_dir = os.path.join(tmp, f"{name}-registry")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)), **(env_extra or {}))
    env.pop("F16_FAULT_INJECT", None)
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "flake16_framework_tpu_torch", *_DRAIN_ARGS,
         "--registry", reg_dir], cwd=tmp, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines, ready = [], threading.Event()

    def reader():
        for line in proc.stdout:
            lines.append(line)
            if line.strip() == "SERVE_READY":
                ready.set()

    thread = threading.Thread(target=reader, daemon=True)
    thread.start()
    try:
        _require(ready.wait(300), "drain drill: no SERVE_READY; output:\n"
                 + "".join(lines[-40:]))
        ready_s = time.time() - t0
        time.sleep(1.0)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    thread.join(10)
    acct = [json.loads(line.split(" ", 1)[1]) for line in lines
            if line.startswith("DRAIN_ACCT ")]
    _require(len(acct) == 1, "drain drill: no DRAIN_ACCT line; output:\n"
             + "".join(lines[-40:]))
    acct = acct[0]
    _require(rc == 0 and acct["drain"]["phase"] == "complete"
             and acct["counts"]["failed"] == 0
             and acct["counts"]["rejected"] == 0
             and acct["counts"]["ok"] > 0,
             f"drain drill: exit {rc}, {json.dumps(acct)}")
    reloaded = ModelRegistry(reg_dir)
    _require(len(reloaded.load()) == len(acct["models"]),
             "drain drill: the reload lost models")
    with open(os.path.join(reg_dir, MANIFEST_FILE)) as fd:
        manifest = json.load(fd)
    rebuilt = ExecutableStore(reloaded).warm_manifest(
        reloaded.models(), manifest["buckets"])
    _require(manifest["backend"] == "cuda" and rebuilt == manifest["models"],
             "drain drill: the flushed manifest differs from the reloaded "
             "store's")
    return {"rc": rc, "ready_s": ready_s, "wall_s": time.time() - t0,
            "drain": acct["drain"], "counts": acct["counts"],
            "models": acct["models"], "manifest_buckets": manifest["buckets"],
            "manifest_equal_after_reload": True}


# The fleet phases: the serve phase's persisted registry (its three
# models, seed 0, full width) behind W = 3 worker processes on the card,
# each with its own CUDA context, at the serve phase's buckets. The
# drill's fleet starts with worker 1 set to SIGKILL itself as its fifth
# score request arrives, with SHAP requests in flight.
FLEET_WORKERS = 3
FLEET_INJECT = "1:5:worker-kill"
# The router re-dispatches an orphan after the repair loop's 50 ms floor,
# not after the dispatch guard's default backoff of seconds.
FLEET_ROUTER_ENV = {"F16_FAULT_BACKOFF_S": "0"}


def _smi_apps():
    """{pid: MiB} of the card's compute processes, as ``nvidia-smi
    --query-compute-apps=pid,used_memory`` lists them. The pids are the
    NVIDIA driver's, not this container's: where every process of the
    shows as one pid, a worker's share is read from the total's growth
    over the fleet's start."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout
    apps = {}
    for line in out.strip().splitlines():
        pid, _, mib = line.partition(",")
        if pid.strip().isdigit() and mib.strip().isdigit():
            apps[int(pid)] = int(mib)
    return apps


def _ready_launches(handle):
    """The launch counts the worker's last WORKER_READY line carries (its
    warm's, as the manager's log keeps them)."""
    from flake16_framework_tpu_torch.serve.fleet import WORKER_READY

    with open(handle.log_path) as fd:
        lines = [ln for ln in fd if ln.startswith(WORKER_READY)]
    return json.loads(lines[-1].split("launches=", 1)[1])


def run_fleet_path(tmp, registry, feats):
    """``serve --fleet 3 --metrics-port 0`` on the card, as the CLI runs
    it: the serve phase's persisted registry behind ``FLEET_WORKERS``
    workers on cuda, the router in front with its federated exporter
    (``register_fleet_sources``), and ``sustained_load`` through it (1024
    requests of 16 rows, 8 clients, predict and SHAP in turn) while
    ``/metrics`` is scraped every 0.5 s (``_scraping``; the bodies are
    checked by ``check_fleet_metrics``). The parent's launch counts are
    set to 0 just before the fleet starts and read just after the load
    (the fleet fits nothing: K1 0); the workers' are read through
    ``stats`` (each starts at 0: its warm, 9 K2 launches, and its share
    of the load). Then the fleet answers a fixed set of rows, one request
    at a time, for ``check_fleet_values``. Returns (launches, report,
    answers)."""
    from flake16_framework_tpu_torch.obs import metrics
    from flake16_framework_tpu_torch.serve.cli import sustained_load
    from flake16_framework_tpu_torch.serve.fleet import Fleet
    from flake16_framework_tpu_torch.serve.router import FleetRouter

    ids = registry.ids()
    smi_before = _smi_apps()
    _reset_counts()
    t0 = time.time()
    fleet = Fleet(registry.root, FLEET_WORKERS,
                  workdir=os.path.join(tmp, "fleet-path"),
                  buckets=SERVE_BUCKETS)
    try:
        fleet.start()
        start_s = time.time() - t0
        with FleetRouter(fleet, environ=FLEET_ROUTER_ENV) as router:
            warm = router.scrape_worker_stats()
            smi_warm = _smi_apps()
            clock = _KindClock(router)
            reg = metrics.register_fleet_sources(
                metrics.register_process_sources(metrics.MetricsRegistry()),
                router)
            with metrics.MetricsServer(reg, port=0) as server:
                with _scraping(server.port) as scraped:
                    load = sustained_load(
                        clock, feats, ids, n_requests=SERVE_REQUESTS,
                        rows=SERVE_ROWS, kinds=("predict", "shap"),
                        clients=SERVE_CLIENTS)
                scraped["last"] = _scrape(server.port)
            after = router.scrape_worker_stats()
            smi_load = _smi_apps()
            parent = _read_counts()
            stats = router.stats()
            answers = {(mid, kind, b): router.score(mid, feats[:b],
                                                    kind=kind, timeout=120)
                       for mid in ids for kind in ("predict", "shap")
                       for b in SERVE_BUCKETS}
    finally:
        fleet.stop()
    _require(load["n_errors"] == 0, f"fleet load errors: {load['errors']}")
    _require(load["completed"] == SERVE_REQUESTS,
             f"fleet load completed {load['completed']} of "
             f"{load['requests']}")
    _require(sorted(warm) == sorted(after) == list(range(FLEET_WORKERS)),
             f"fleet stats from workers {sorted(warm)}, {sorted(after)}")
    n_warm = len(ids) * len(SERVE_BUCKETS)
    workers = []
    for i in range(FLEET_WORKERS):
        w, a = warm[i], after[i]
        _require(w["device"].startswith("cuda")
                 and w["launches"]["treeshap_unit"] == n_warm
                 and a["launches"]["hist_cumsum"] == 0,
                 f"fleet worker {i}: {w['device']}, launches "
                 f"{w['launches']} at ready, {a['launches']} after")
        workers.append({
            "pid": a["pid"], "ready_s": fleet.workers[i].ready_s[0],
            "requests": a["requests"], "p50_ms": a["p50_ms"],
            "p99_ms": a["p99_ms"], "launches_warm": w["launches"],
            "launches": a["launches"],
            "max_memory_allocated_mb": a.get("max_memory_allocated_mb")})
    k2 = sum(w["launches"]["treeshap_unit"] for w in workers)
    _require(k2 > FLEET_WORKERS * n_warm and parent["hist_cumsum"] == 0,
             f"fleet K2 launches in the workers {k2}, parent {parent}")
    launches = {"hist_cumsum": parent["hist_cumsum"], "treeshap_unit": k2}
    smi = {k: sum(v.values()) for k, v in (
        ("before", smi_before), ("warm", smi_warm), ("load", smi_load))}
    report = {"workers": workers, "start_s": start_s, "load": load,
              "by_kind": clock.by_kind(load["wall_s"]),
              "metrics": check_fleet_metrics(scraped, load),
              "router": stats["router"], "parent_launches": parent,
              "smi_apps": {"before": smi_before, "warm": smi_warm,
                           "load": smi_load},
              "smi_total_mib": smi,
              "smi_mib_per_worker": {
                  k: (smi[k] - smi["before"]) / FLEET_WORKERS
                  for k in ("warm", "load")}}
    return launches, report, answers


def check_fleet_values(answers, registry, feats):
    """The fleet's answers for each model, kind and bucket (rows
    ``feats[:bucket]``, one request at a time) against the in-process
    store on the card over the same persisted registry, reloaded here as
    the workers load it: predict exactly, SHAP within SHAP_TOL, and
    whether SHAP is bitwise. (A reload, not the serve phase's in-memory
    models: K2's chunks, and so its summation order, follow the rows the
    forest gives.)"""
    from flake16_framework_tpu_torch.serve import ExecutableStore, ModelRegistry

    reloaded = ModelRegistry(registry.root)
    reloaded.load()
    store = ExecutableStore(reloaded)
    rows = []
    for (mid, kind, b), got in answers.items():
        model = reloaded.get(mid)
        x = np.ascontiguousarray(feats[:b, list(model.cols)],
                                 dtype=np.float32)
        want = store.call(model, kind, x).cpu().numpy()
        err = float(np.abs(got - want).max())
        ref = float(np.abs(want).max())
        bitwise = got.dtype == want.dtype and got.tobytes() == want.tobytes()
        if kind == "predict":
            _require(bitwise, f"fleet {mid} predict@{b}: off the in-process "
                     f"store by {err}")
        else:
            _require(err <= SHAP_TOL[0] * ref + SHAP_TOL[1],
                     f"fleet {mid} shap@{b}: off the in-process store by "
                     f"{err} (max {ref})")
        rows.append({"model": mid, "kind": kind, "bucket": b,
                     "bitwise": bitwise, "max_abs_err": err,
                     "max_abs": ref})
    return rows


class _ClosedLoop:
    """Clients scoring through the router until stopped (predict and SHAP
    in turn, 16-row windows, models round robin), every outcome counted:
    an exception is a request lost to the client."""

    def __init__(self, router, feats, model_ids, clients=SERVE_CLIENTS):
        import threading

        self.ok = 0
        self.errors = []
        self._lock = threading.Lock()
        self._stop = threading.Event()

        def client(ci):
            j = ci
            while not self._stop.is_set():
                off = (j * SERVE_ROWS) % (feats.shape[0] - SERVE_ROWS)
                try:
                    router.score(model_ids[j % len(model_ids)],
                                 feats[off:off + SERVE_ROWS],
                                 kind=("predict", "shap")[j % 2],
                                 timeout=120)
                    with self._lock:
                        self.ok += 1
                except Exception as e:  # the verdict's data
                    with self._lock:
                        self.errors.append(repr(e))
                j += clients

        self._threads = [threading.Thread(target=client, args=(ci,),
                                          daemon=True)
                         for ci in range(clients)]
        for t in self._threads:
            t.start()

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(180)
        _require(not any(t.is_alive() for t in self._threads),
                 "fleet drill: a client did not finish")


def _await(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not cond():
        _require(time.monotonic() < deadline, f"fleet drill: {what}")
        time.sleep(0.05)


def _served(router):
    """Requests each worker reports served (its heartbeat's count)."""
    return [w["hb"].get("requests") or 0 for w in router.stats()["workers"]]


def run_fleet_drill(tmp, registry, feats):
    """The fleet drill on the card, under a closed-loop load of 8 clients
    through the router the whole time: a fleet of ``FLEET_WORKERS`` whose
    worker 1 SIGKILLs itself as its fifth score request arrives
    (``F16_FAULT_INJECT=1:5:worker-kill``, SHAP requests in flight), then,
    once its failover window has closed, a SIGKILL of worker 0 from here;
    both respawn together; then a rolling restart of all three. Zero
    client-visible errors; each kill's failover window closed, the
    workers not killed answering through it, each respawn charged to the
    budget and re-warmed (its K2 launches); every pid new after the
    walk."""
    import signal

    from flake16_framework_tpu_torch.serve.fleet import Fleet
    from flake16_framework_tpu_torch.serve.router import FleetRouter

    env = dict(os.environ, F16_FAULT_INJECT=FLEET_INJECT)
    t0 = time.time()
    fleet = Fleet(registry.root, FLEET_WORKERS,
                  workdir=os.path.join(tmp, "fleet-drill"),
                  buckets=SERVE_BUCKETS, env=env)
    kills = []
    try:
        fleet.start()
        with FleetRouter(fleet, environ=FLEET_ROUTER_ENV) as router:
            load = _ClosedLoop(router, feats, registry.ids())
            try:
                # Worker 1 dies by its plan within the load's first
                # requests; as soon as its failover window has closed,
                # worker 0 is SIGKILLed, and the two respawn together.
                for victim, how in ((1, "worker-kill"), (0, "SIGKILL")):
                    handle = fleet.workers[victim]
                    old_pid, n_fo = handle.pid, len(router.failovers)
                    served = _served(router)
                    if how == "SIGKILL":
                        os.kill(old_pid, signal.SIGKILL)
                    _await(lambda: handle.restarts >= 1, 120,
                           f"{how} of worker {victim} not seen")
                    # The window closes when the last orphan (a request
                    # in flight at the kill) settles elsewhere; a kill
                    # that found none opens no window.
                    _await(lambda: len(router.failovers) > n_fo
                           or handle.pid != old_pid, 60,
                           f"{how}: no respawn of worker {victim}")
                    time.sleep(0.5)  # the survivors' next heartbeats
                    fo = (dict(router.failovers[-1])
                          if len(router.failovers) > n_fo else None)
                    after = _served(router)
                    survivors = [i for i in range(FLEET_WORKERS)
                                 if fleet.workers[i].restarts == 0]
                    _require(all(after[i] > served[i] for i in survivors),
                             f"{how}: survivors served {served} -> {after}")
                    kills.append({
                        "how": how, "worker": victim, "old_pid": old_pid,
                        "failover_s": (fo["t_recovered"] - fo["t_detect"]
                                       if fo else None),
                        "orphans": fo["n_orphans"] if fo else 0,
                        "survivors_served": {i: after[i] - served[i]
                                             for i in survivors}})
                fleet.wait_ready([1, 0])
                for k in kills:
                    handle = fleet.workers[k["worker"]]
                    _await(lambda: router.links[k["worker"]].hb.get("pid")
                           == handle.pid, 60, f"{k['how']}: no heartbeat "
                           f"from the respawned worker {k['worker']}")
                    _require(handle.restarts == 1 and not handle.failed
                             and handle.pid != k["old_pid"],
                             f"{k['how']}: worker {k['worker']} restarts "
                             f"{handle.restarts}, failed {handle.failed}")
                    k.update(new_pid=handle.pid, restarts=handle.restarts,
                             ready_s=handle.ready_s[-1],
                             rewarm_launches=_ready_launches(handle))
                pids_before = fleet.pids()
                errors_before = len(load.errors)
                rolling = router.rolling_restart(drain_deadline_s=15)
                _require(not set(fleet.pids()) & set(pids_before)
                         and len(rolling["steps"]) == FLEET_WORKERS,
                         f"rolling restart: pids {pids_before} -> "
                         f"{fleet.pids()}")
                _require(len(load.errors) == errors_before,
                         f"rolling restart errors: {load.errors[-8:]}")
                time.sleep(1.0)  # the load through the new fleet
            finally:
                load.stop()
            stats = router.stats()
    finally:
        fleet.stop()
    _require(not load.errors, f"fleet drill errors: {load.errors[:8]}")
    n_warm = len(registry.ids()) * len(SERVE_BUCKETS)
    for k in kills:
        _require(k["rewarm_launches"]["treeshap_unit"] == n_warm,
                 f"{k['how']}: re-warm launches {k['rewarm_launches']}")
    return {"kills": kills, "rolling": rolling, "ok": load.ok,
            "errors": len(load.errors), "router": stats["router"],
            "ready_s": [h.ready_s for h in fleet.workers],
            "wall_s": time.time() - t0}


def print_fleet(fleet_rep, fleet_launches, drill, smi):
    """The fleet phases' lines (``smi`` is the card's name and limit)."""
    for i, w in enumerate(fleet_rep["workers"]):
        print(f"fleet worker {i} ({smi}): pid {w['pid']}, ready after "
              f"{w['ready_s']:.3f} s, {w['requests']} requests (p50 "
              f"{w['p50_ms']} ms, p99 {w['p99_ms']} ms), K2 "
              f"{w['launches']['treeshap_unit']} launches "
              f"({w['launches_warm']['treeshap_unit']} at warm), K1 "
              f"{w['launches']['hist_cumsum']}, max allocated "
              f"{w['max_memory_allocated_mb']:.1f} MB", flush=True)
    fl = fleet_rep["load"]
    print(f"fleet path ({smi}): {FLEET_WORKERS} workers ready in "
          f"{fleet_rep['start_s']:.2f} s; load {fl['requests']} "
          f"requests of {fl['rows']} rows from {fl['clients']} clients "
          f"in {fl['wall_s']:.3f} s, {fl['rps']} rps, p50 "
          f"{fl['p50_ms']} ms, p99 {fl['p99_ms']} ms, n_errors "
          f"{fl['n_errors']}; router {json.dumps(fleet_rep['router'])}; "
          f"launches {fleet_launches}; nvidia-smi compute apps' total "
          f"{json.dumps(fleet_rep['smi_total_mib'])} MiB, a worker "
          f"{json.dumps(fleet_rep['smi_mib_per_worker'])} MiB",
          flush=True)
    fm = fleet_rep["metrics"]
    print(f"fleet metrics ({smi}): {fm['scrapes']} scrapes of "
          f"{fm['series']} series, all valid (mean "
          f"{fm['scrape_ms_mean']:.2f} ms, max {fm['scrape_ms_max']:.2f} ms a"
          f" scrape); workers up {FLEET_WORKERS}, router requests_total "
          f"{fm['fleet_requests_total']:.0f}, worker requests (heartbeats) "
          f"{json.dumps(fm['worker_requests'])}", flush=True)
    for kind, k in fleet_rep["by_kind"].items():
        print(f"fleet {kind} ({smi}): {k['requests']} requests, "
              f"{k['rps']:.1f} rps, p50 {k['p50_ms']:.3f} ms, p99 "
              f"{k['p99_ms']:.3f} ms (client side)", flush=True)
    vals = fleet_rep["values"]
    shap_vals = [r for r in vals if r["kind"] == "shap"]
    print(f"fleet values against the in-process store (reloaded "
          f"registry): predict bitwise in all {len(vals) - len(shap_vals)}"
          f", SHAP bitwise in {sum(r['bitwise'] for r in shap_vals)} of "
          f"{len(shap_vals)}, max err "
          f"{max(r['max_abs_err'] for r in shap_vals):.3g}", flush=True)
    for k in drill["kills"]:
        fo = ("none (no request in flight)" if k["failover_s"] is None
              else f"{k['failover_s']:.4f} s over {k['orphans']} "
              f"orphans")
        print(f"fleet drill {k['how']} of worker {k['worker']} "
              f"({smi}): failover window {fo}, restarts "
              f"{k['restarts']}, respawn ready after "
              f"{k['ready_s']:.3f} s, re-warm K2 "
              f"{k['rewarm_launches']['treeshap_unit']} launches, "
              f"survivors served {json.dumps(k['survivors_served'])}",
              flush=True)
    print(f"fleet drill rolling restart ({smi}): steps "
          f"{[st['wall_s'] for st in drill['rolling']['steps']]} s, "
          f"all pids new; {drill['ok']} requests answered, "
          f"{drill['errors']} errors through both kills and the walk; "
          f"router {json.dumps(drill['router'])}; drill wall "
          f"{drill['wall_s']:.1f} s", flush=True)


# The crash-tolerance drills run ``write_scores`` in child processes on
# the three configs below: an RF and an ET config on K1, a Decision Tree
# on the exact grower; all three are in the scores path, whose results are
# the uninterrupted run they are held against.
DRILL_CONFIGS = (MAIN_CONFIGS[0], MAIN_CONFIGS[1], DT_CONFIGS[0])

# One ``write_scores`` run of the drill configs at full width. ``faulty``
# (a config's keys joined by "/", or "") makes that config's guarded run
# start with an out-of-range index on the card: a real device-side assert,
# which kills the process's CUDA context. The last line is the kernels'
# launch counts of this process. Telemetry is on when ``F16_TELEMETRY``
# is set.
_DRILL_CHILD = """
import json, sys, torch
from flake16_framework_tpu_torch import obs
from flake16_framework_tpu_torch.kernels.hist import cum_hists
from flake16_framework_tpu_torch.kernels.treeshap_unit import unit_shap
from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
from flake16_framework_tpu_torch.pipeline import write_scores
tests_file, out_file, configs, faulty = sys.argv[1:5]
real = SweepEngine.run_config
def run_config(self, keys):
    if "/".join(keys) == faulty:
        x = torch.zeros(4, device=self.device)
        x[torch.tensor([10], device=self.device)] += 1.0
    return real(self, keys)
SweepEngine.run_config = run_config
obs.configure_from_env()
try:
    write_scores(tests_file, out_file, max_depth=48,
                 configs=[tuple(k) for k in json.loads(configs)])
finally:
    print("launches: " + json.dumps({"hist_cumsum": cum_hists.launches,
                                     "treeshap_unit": unit_shap.launches}),
          flush=True)
"""


def _drill(tmp, name, out_file, faulty="", inject="", supervised=False,
           env_extra=None):
    """One drill child (under ``supervise`` when asked) with its output in
    ``<tmp>/<name>.log``; ``env_extra`` joins its environment. Returns
    (rc, history, log text)."""
    from flake16_framework_tpu_torch.resilience.supervisor import supervise

    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)), **(env_extra or {}))
    env.pop("F16_FAULT_INJECT", None)
    if inject:
        env["F16_FAULT_INJECT"] = inject
    argv = [sys.executable, "-c", _DRILL_CHILD,
            os.path.join(tmp, "tests.json"), out_file,
            json.dumps(DRILL_CONFIGS), faulty]
    log_path = os.path.join(tmp, f"{name}.log")
    with open(log_path, "w") as log:
        if supervised:
            rc, history = supervise(argv, env=env, cwd=tmp, stdout=log,
                                    stderr=subprocess.STDOUT, warn_out=log,
                                    max_restarts=1)
        else:
            rc = subprocess.run(argv, env=env, cwd=tmp, stdout=log,
                                stderr=subprocess.STDOUT,
                                timeout=600).returncode
            history = []
    with open(log_path) as fd:
        return rc, history, fd.read()


def _same_scores(path, ref, what):
    """The pickle at ``path`` holds exactly the drill configs, each with
    the scores content (v[2:]; v[:2] are wall clocks) of ``ref``."""
    with open(path, "rb") as fd:
        got = pickle.load(fd)
    _require(set(got) == set(DRILL_CONFIGS), f"{what}: keys {sorted(got)}")
    for k in DRILL_CONFIGS:
        _require(pickle.dumps(got[k][2:]) == pickle.dumps(ref[k][2:]),
                 f"{what}: {k} differs from the uninterrupted run")


def run_kill_drill(tmp, ref):
    """A SIGKILL right after the journal fsyncs fold 4 of the ET config,
    in a child under ``supervise``, telemetry on in the child (with a
    flight ring) and here: one signal-9 death, the ring dumped and one
    ``restart`` event here, a restart that replays the journal and exits
    0, K1 launched in the resumed child, the scores equal to the
    uninterrupted run's, the journal gone."""
    from flake16_framework_tpu_torch import obs
    from flake16_framework_tpu_torch.config import iter_config_keys
    from flake16_framework_tpu_torch.obs import report

    et = list(iter_config_keys()).index(DRILL_CONFIGS[1])
    out_file = os.path.join(tmp, "scores-kill.pkl")
    ring = os.path.join(tmp, "kill-flight.bin")
    t0 = time.time()
    run_dir = obs.configure(root=os.path.join(tmp, "kill-telemetry"))
    try:
        rc, history, text = _drill(
            tmp, "kill", out_file, inject=f"{et}:4:sigkill", supervised=True,
            env_extra={"F16_TELEMETRY": os.path.join(tmp, "kill-children"),
                       "F16_FLIGHT": ring})
    finally:
        obs.shutdown()
    wall = time.time() - t0
    _, events = report.load_run(run_dir)
    restarts = [(e["attempt"], e["rc"]) for e in events
                if e["kind"] == "restart"]
    dumps = [e["n"] for e in events
             if e["kind"] == "flight" and e["action"] == "dump"]
    _require(restarts == [(1, -9)] and len(dumps) == 1 and dumps[0] > 0,
             f"kill drill telemetry: restarts {restarts}, dumps {dumps}")
    _require(rc == 0, f"kill drill: final rc {rc}\n{text[-3000:]}")
    _require([h["signal"] for h in history] == [9],
             f"kill drill: deaths {history}")
    m = re.search(r"journal: replayed (\d+) completed config\(s\) and "
                  r"(\d+) partial fold\(s\)", text)
    _require(m is not None and int(m[1]) > 0 and int(m[2]) > 0,
             f"kill drill: no replay line\n{text[-3000:]}")
    _same_scores(out_file, ref, "kill drill")
    _require(not os.path.exists(out_file + ".journal"), "journal left")
    launches = json.loads(text.rsplit("launches: ", 1)[1].splitlines()[0])
    _require(launches["hist_cumsum"] > 0, "no K1 launch after the restart")
    return {"deaths": history, "rc": rc, "replayed_configs": int(m[1]),
            "replayed_folds": int(m[2]), "resumed_child_launches": launches,
            "journal": _journal_stats(text), "wall_s": wall,
            "restart_events": restarts, "flight_dump_records": dumps[0]}


def run_sticky_fault_drill(tmp, ref):
    """A real device-side assert in the guarded run of the second config:
    that config is quarantined as ``deterministic`` after one attempt, the
    config after it fails at once on the dead context and is quarantined
    too, the first config is in the pickle, and the process exits with 23
    (the pickle, the sidecar and the journal's end touch no CUDA). A child
    in a fresh process then resumes from that pickle (``write_scores`` is
    what ``resume`` runs) and completes every config with the
    uninterrupted run's scores."""
    from flake16_framework_tpu_torch.resilience import quarantine

    out_file = os.path.join(tmp, "scores-fault.pkl")
    faulty = DRILL_CONFIGS[1]
    t0 = time.time()
    rc, _, text = _drill(tmp, "fault", out_file, faulty="/".join(faulty))
    _require(rc == quarantine.QUARANTINE_EXIT_CODE,
             f"sticky fault: exit {rc}\n{text[-3000:]}")
    side = quarantine.load_sidecar(quarantine.sidecar_path(out_file))
    rec = side.get(faulty, {})
    _require(rec.get("fault_class") == "deterministic"
             and len(rec.get("attempts", ())) == 1,
             f"sticky fault: sidecar {side}")
    with open(out_file, "rb") as fd:
        first = pickle.load(fd)
    _require(DRILL_CONFIGS[0] in first and faulty not in first,
             f"sticky fault: pickle holds {sorted(first)}")
    _require(not os.path.exists(out_file + ".journal"), "journal left")
    fault_s = time.time() - t0
    rc2, _, text2 = _drill(tmp, "fault-resume", out_file)
    _require(rc2 == 0, f"resume after the fault: exit {rc2}\n"
             f"{text2[-3000:]}")
    _same_scores(out_file, ref, "resume after the fault")
    _require(quarantine.load_sidecar(quarantine.sidecar_path(out_file))
             == {}, "sidecar not cleared by the resume")
    return {"rc": rc, "sidecar": {"/".join(k): v for k, v in side.items()},
            "error": rec["attempts"][0]["error"],
            "in_pickle_after_fault": ["/".join(k) for k in first],
            "fault_run_s": fault_s, "resume_rc": rc2,
            "resume_s": time.time() - t0 - fault_s}


def run_oom_drill():
    """A guarded thunk whose first attempt allocates more than the card
    holds and whose second runs K1 at the full window: one retry, of class
    ``oom``, and K1's result bitwise equal to a direct call."""
    from flake16_framework_tpu_torch.kernels.hist import cum_hists
    from flake16_framework_tpu_torch.resilience import guard

    args = synthetic_hist_inputs()
    g = guard.DispatchGuard(policy=guard.BackoffPolicy(max_attempts=2,
                                                       base_s=0.0),
                            device=torch.device("cuda"))
    calls = [0]

    def thunk():
        calls[0] += 1
        if calls[0] == 1:
            torch.empty(2 ** 40, dtype=torch.uint8, device="cuda")
        return cum_hists(*args)

    got = g.call(thunk, label="oom drill")
    want = cum_hists(*args)
    torch.cuda.synchronize()
    _require([r["fault_class"] for r in g.retries] == ["oom"],
             f"oom drill: retries {g.retries}")
    _require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
             "oom drill: K1 after the retry differs from a direct call")
    return {"retries": g.retries, "attempts": calls[0], "bitwise": True}


def _device_kernels(prof):
    """[(ms, name, launches)] of the CUDA kernels (and memsets and copies)
    in a finished profile, largest first. Reads the profiler's raw events,
    which gives what ``key_averages()`` gives for device events without
    building the host-side event tree (tens of seconds a config). The raw
    events are a private interface of the profiler: ``python3
    measure_grid.py --check-profiler`` holds this reading against
    ``key_averages()`` on the configs profiled here."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        ns, count = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (ns + e.duration_ns(), count + 1)
    return sorted(((ns / 1e6, name, count)
                   for name, (ns, count) in by_name.items()), reverse=True)


def _profiled(fn):
    """Run ``fn`` under the profiler (CPU and CUDA) and return its device
    kernels (``_device_kernels``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _device_kernels(prof)


def tree_levels(forest):
    """For each tree of an exact-grower forest, the levels its grower ran,
    which are its host reads: the deepest node's depth plus one, or the
    depth bound where growth reached it. Child ids exceed their parent's."""
    out = []
    for t in range(forest.feature.shape[0]):
        n = int(forest.n_nodes[t])
        left = forest.left[t, :n].cpu().numpy()
        right = forest.right[t, :n].cpu().numpy()
        depth = np.zeros(n, np.int64)
        for i in range(n):
            if left[i] >= 0:
                depth[left[i]] = depth[right[i]] = depth[i] + 1
        deepest = int(depth.max())
        out.append(deepest + 1 if deepest < forest.max_depth else deepest)
    return out


def check_exact_fold(tests_file):
    """Fold 0 of the first Decision Tree config at full width: the exact
    grower's forest on the card from the sweep's own resampled tensors and
    key, bitwise against the CPU's from the same tensors. Then that fit
    alone, unprofiled (wall) and profiled (kernel launches and busy ms), a
    level being one host read."""
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.ops import trees
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    engine = SweepEngine(*tests_to_arrays(load_tests(tests_file)))
    args, kwargs = first_fold(engine, DT_CONFIGS[0], "fit_forest",
                              run_fit=False)
    card = trees.fit_forest(*args, **kwargs)
    cpu = trees.fit_forest(*[a.cpu() for a in args], **kwargs)
    for fld in trees.Forest._fields[:-1]:
        if not torch.equal(getattr(cpu, fld), getattr(card, fld).cpu()):
            raise AssertionError(f"exact grower, {DT_CONFIGS[0]} fold 0, "
                                 f"field {fld}: card and CPU differ")
    levels = sum(tree_levels(card))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trees.fit_forest(*args, **kwargs)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _profiled(lambda: trees.fit_forest(*args, **kwargs))
    launches = sum(k[2] for k in kernels)
    busy_ms = sum(k[0] for k in kernels)
    return {
        "config": "/".join(DT_CONFIGS[0]), "fold": 0, "bitwise": True,
        "samples": int(args[0].shape[0]),
        "live_samples": int((args[2] > 0).sum()),
        "n_nodes": int(card.n_nodes[0]), "levels": levels,
        "wall_ms": wall_ms, "wall_ms_per_level": wall_ms / levels,
        "kernel_launches": launches, "launches_per_level": launches / levels,
        "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms
        / wall_ms,
        "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                        for ms, n, c in kernels[:10]],
    }


def profile_config(tests_file, config, wall_s):
    """Device time by kernel over one more full-width run of ``config``,
    outside the counted main path. Kernel times are the card's own; the
    profiler slows the host, so shares of the wall use ``wall_s``, the
    config's unprofiled ``run_config`` wall (fit + predict over its 10
    folds) from the main path. For a Decision Tree config, ``levels`` is
    the exact grower's levels (its host reads) over the 10 folds."""
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.ops import trees
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    engine = SweepEngine(*tests_to_arrays(load_tests(tests_file)))
    real_fit, forests = trees.fit_forest, []

    def keep(*args, **kwargs):
        forests.append(real_fit(*args, **kwargs))
        return forests[-1]

    trees.fit_forest = keep
    try:
        kernels = _profiled(lambda: engine.run_config(config))
    finally:
        trees.fit_forest = real_fit
    busy_ms = sum(k[0] for k in kernels)
    hist_ms = sum(k[0] for k in kernels if "hist_cumsum" in k[1])
    hist_n = sum(k[2] for k in kernels if "hist_cumsum" in k[1])
    return {
        "config": "/".join(config), "wall_s_unprofiled": wall_s,
        "kernel_launches": sum(k[2] for k in kernels),
        "device_busy_ms": busy_ms, "hist_cumsum_ms": hist_ms,
        "hist_cumsum_launches": hist_n,
        "hist_share_of_device": hist_ms / busy_ms if busy_ms else None,
        "device_idle_share": 1.0 - busy_ms / 1e3 / wall_s,
        "levels": sum(sum(tree_levels(f)) for f in forests) or None,
        "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                        for ms, n, c in kernels[:15]],
    }


# -- the performance database, the metrics exporter, the witness --------

# The tuned window width and warm ladder the ``perfdb_path`` phase
# records: a width other than the default 128 and inside K1's shared
# memory (``kernels/hist.max_window``: 226 at 64 bins).
TUNED_NODE_BATCH = 64
RECORDED_BUCKETS = (16, 64)


def _scrape(port):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10.0) as resp:
        return resp.read().decode()


@contextlib.contextmanager
def _scraping(port, period_s=0.5):
    """GET ``/metrics`` every ``period_s`` on a thread for the block;
    yields {"bodies": [...], "walls_s": [...], "errors": [...]}, each
    body to be held valid by the caller."""
    import threading

    out = {"bodies": [], "walls_s": [], "errors": []}
    stop = threading.Event()

    def loop():
        while True:
            t0 = time.perf_counter()
            try:
                out["bodies"].append(_scrape(port))
            except Exception as e:  # noqa: BLE001 - reported, then failed
                out["errors"].append(repr(e))
            out["walls_s"].append(time.perf_counter() - t0)
            if stop.wait(period_s):
                return

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join(30)


def _samples(body, name):
    """{label set ("" for none): value} of one series in a body."""
    out = {}
    for line in body.splitlines():
        if line.startswith((name + " ", name + "{")):
            key, _, value = line.rpartition(" ")
            out[key[len(name):]] = float(value)
    return out


def _check_bodies(scraped, what):
    from flake16_framework_tpu_torch.obs.metrics import validate_exposition

    bodies = scraped["bodies"] + [scraped["last"]]
    bad = [p for b in bodies for p in validate_exposition(b)]
    _require(not scraped["errors"] and not bad and len(bodies) >= 2,
             f"{what}: {len(bodies)} scrapes, errors {scraped['errors'][:3]}"
             f", invalid {bad[:3]}")
    return {"scrapes": len(bodies),
            "scrape_ms_max": 1e3 * max(scraped["walls_s"]),
            "scrape_ms_mean": 1e3 * sum(scraped["walls_s"])
            / len(scraped["walls_s"]),
            "series": len({ln.split()[2] for ln in scraped["last"]
                           .splitlines() if ln.startswith("# TYPE ")})}


def check_fleet_metrics(scraped, load):
    """The federated endpoint's bodies, scraped during ``fleet_path``'s
    load and once after it: every one valid, the last with
    ``f16_fleet_workers_up`` 3, per-worker series for workers 0-2 (each
    worker's request count from its last heartbeat, which may lag the
    load's end) and the router's request count equal to the load's."""
    rep = _check_bodies(scraped, "fleet metrics")
    last = scraped["last"]
    labels = [f'{{worker="{i}"}}' for i in range(FLEET_WORKERS)]
    up = _samples(last, "f16_fleet_worker_up")
    served = _samples(last, "f16_fleet_worker_requests_total")
    total = _samples(last, "f16_fleet_requests_total")
    _require(_samples(last, "f16_fleet_workers_up") == {"": FLEET_WORKERS}
             and up == {k: 1.0 for k in labels}
             and sorted(served) == labels and min(served.values()) > 0
             and total == {"": float(load["completed"])},
             f"fleet metrics: workers up {up}, served {served}, router "
             f"total {total} of {load['completed']}")
    rep["worker_requests"] = served
    rep["fleet_requests_total"] = total[""]
    return rep


def run_metrics_path(registry, feats):
    """``serve_path``'s service (its registry, buckets and load) with
    ``metrics_port=0``, ``/metrics`` scraped every 0.5 s during
    ``sustained_load`` and once after it: every body valid, the last
    ``f16_serve_requests_total`` the load's completed count and
    ``f16_device_mem_peak_mb`` above 0. The launch counts are set to 0
    just before the service starts and read after the load (K2: 9 at
    warm, then one a SHAP microbatch). Returns (launches, report)."""
    from flake16_framework_tpu_torch.serve import ScoringService
    from flake16_framework_tpu_torch.serve.cli import sustained_load

    _reset_counts()
    svc = ScoringService(registry, buckets=SERVE_BUCKETS, metrics_port=0)
    svc.start()
    try:
        port = svc.metrics.port
        with _scraping(port) as scraped:
            load = sustained_load(svc, feats, registry.ids(),
                                  n_requests=SERVE_REQUESTS, rows=SERVE_ROWS,
                                  kinds=("predict", "shap"),
                                  clients=SERVE_CLIENTS)
        scraped["last"] = _scrape(port)
        launches = _read_counts()
    finally:
        svc.stop()
    _require(load["n_errors"] == 0 and load["completed"] == SERVE_REQUESTS,
             f"metrics path load: {load['completed']} completed, errors "
             f"{load['errors']}")
    rep = _check_bodies(scraped, "serve metrics")
    last = scraped["last"]
    done = _samples(last, "f16_serve_requests_total")
    mem = _samples(last, "f16_device_mem_peak_mb")
    _require(done == {"": float(load["completed"])}
             and mem.get("", 0.0) > 0,
             f"serve metrics: requests_total {done}, device memory {mem}")
    _require(launches["treeshap_unit"] > len(registry) * len(SERVE_BUCKETS)
             and launches["hist_cumsum"] == 0,
             f"metrics path launches {launches}")
    rep.update(port=port, load=load, device_mem_peak_mb=mem[""],
               requests_total=done[""])
    return launches, rep


def check_tuned_steps(tests_file):
    """K1 on every fold-batched BFS step of the RF member grown at the
    tuned window width (``TUNED_NODE_BATCH``, the keyword ``run_plan``
    hands the grower under ``perfdb_path``'s tuned row): every window that
    wide, each step's output bitwise equal to the plain version's and to
    a second run's."""
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.kernels.hist import (
        cum_hists, cum_hists_plain,
    )
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    config = MAIN_CONFIGS[0]
    engine = SweepEngine(*tests_to_arrays(load_tests(tests_file)))
    steps = record_steps(engine, config, fold_batched=True,
                         node_batch=TUNED_NODE_BATCH)
    _require(steps and {s[4] for s in steps} == {TUNED_NODE_BATCH},
             f"tuned steps: windows {sorted({s[4] for s in steps})}")
    for s in steps:
        got, again = cum_hists(*s), cum_hists(*s)
        want = cum_hists_plain(*s)
        _require(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"hist_cumsum differs from plain on a fold-batched step "
                 f"of {config} at W = {TUNED_NODE_BATCH}")
        _require(all(torch.equal(a, b) for a, b in zip(got, again)),
                 f"hist_cumsum: two runs differ on a fold-batched step of "
                 f"{config} at W = {TUNED_NODE_BATCH}")
        del got, again, want
    return {"config": "/".join(config), "steps": len(steps),
            "window": TUNED_NODE_BATCH, "trees": int(steps[0][0].shape[0]),
            "groups": int(steps[0][3].shape[0])}


def _planner_run(tmp, tj, name, configs, want):
    """``scores planner`` on ``configs`` with telemetry on (its run
    directory under ``tmp``), the launch counts set to 0 just before and
    read just after (``_run_scores``); its scores must equal ``want``'s
    (v[2:] bitwise). Returns (launches, wall, run directory)."""
    from flake16_framework_tpu_torch import obs

    out_file = os.path.join(tmp, f"scores-{name}.pkl")
    run_dir = obs.configure(root=os.path.join(tmp, f"{name}-telemetry"),
                            heartbeat_s=0)
    try:
        t0 = time.time()
        _, launches, _, _, _ = _run_scores(tj, out_file, configs,
                                           planner=True)
        wall = time.time() - t0
    finally:
        obs.shutdown()
    with open(out_file, "rb") as fd:
        got = pickle.load(fd)
    for k in configs:
        _require(pickle.dumps(got[k][2:]) == pickle.dumps(want[k][2:]),
                 f"perfdb path ({name}): {k} differs from the planner path")
    return launches, wall, run_dir


def run_perfdb_path(tmp, tj, tel, tel_launches, planner_launches, registry,
                    feats):
    """The performance database on the card, in a fresh file
    (``F16_PERFDB``): ``perf ingest`` of ``telemetry_path``'s run (rows on
    ``cuda``, kernel rows with that run's launches); ``scores planner``
    on the planner path's configs under telemetry with the empty
    database (K1 launches equal to the planner path's), then, under a
    recorded ``plan_pad_to`` and a tuned window width
    (``TUNED_NODE_BATCH``) at the RF and ET plan shape, once more (launch
    counts set to 0 just before each run, read just after): scores
    bitwise equal to the planner path's pickle, a K1 count other than its
    own; K1 held bitwise against its plain version on every step of the
    RF member at that width (``check_tuned_steps``); ``perf diff`` of the
    two runs; and a service built without buckets under a recorded
    ``serve_buckets`` row, which warms exactly that ladder, its served
    values held against the direct calls at those sizes and K2 against
    its plain version on the serving rows at those sample counts.
    Returns (launches by sub-path, report)."""
    from flake16_framework_tpu_torch.obs import perf_diff, perfdb
    from flake16_framework_tpu_torch.parallel import planner
    from flake16_framework_tpu_torch.serve import ScoringService
    from flake16_framework_tpu_torch.serve.service import (
        DEFAULT_BUCKETS, resolve_buckets,
    )

    db = os.path.join(tmp, "perfdb.jsonl")
    saved = os.environ.get(perfdb.DB_ENV)
    os.environ[perfdb.DB_ENV] = db
    try:
        perf_diff.perf_main(["ingest", tel["run_dir"]], out=io.StringIO())
        rows = perfdb.load(db)
        kern = {r["kernel"]: r["metrics"]["n"] for r in rows
                if r["kernel"].startswith("kernel.")}
        _require(rows and {r["backend"] for r in rows} == {"cuda"}
                 and kern == {"kernel.hist_cumsum": tel_launches[
                     "hist_cumsum"], "kernel.treeshap_unit": tel_launches[
                     "treeshap_unit"]},
                 f"perf ingest: backends {sorted({r['backend'] for r in rows})}"
                 f", kernel rows {kern} against {tel_launches}")
        configs = MAIN_CONFIGS + DT_CONFIGS
        with open(os.path.join(tmp, "scores-planner.pkl"), "rb") as fd:
            want = pickle.load(fd)
        untuned, untuned_wall, untuned_run = _planner_run(
            tmp, tj, "untuned", configs, want)
        _require(untuned == planner_launches,
                 f"perfdb path: untuned launches {untuned} against the "
                 f"planner path's {planner_launches}")
        shape = planner.plan_shape("Flake16", MAIN_CONFIGS[0][4], n=N_TESTS,
                                   n_folds=10)
        sig = perfdb.shape_sig(shape)
        perfdb.record_tuned("cuda", sig, "fit", {"plan_pad_to": 2},
                            {"fit_s": 1.0})
        for keys in MAIN_CONFIGS:
            _require(planner.plan_shape(keys[1], keys[4], n=N_TESTS,
                                        n_folds=10) == shape, "plan shapes")
            perfdb.record_tuned(
                "cuda", sig, perfdb.model_kernel(keys[4]),
                {"F16_HIST_NODE_BATCH": str(TUNED_NODE_BATCH)},
                {"fit_s": 1.0})
            _require(perfdb.tuned_fit_overrides(
                "cuda", shape, model=keys[4]) == {
                    "node_batch": TUNED_NODE_BATCH}, "tuned override")
        launches, wall, run_dir = _planner_run(tmp, tj, "tuned", configs,
                                               want)
        _require(launches["hist_cumsum"] > planner_launches["hist_cumsum"],
                 f"perfdb path: K1 {launches} at width {TUNED_NODE_BATCH} "
                 f"against the planner path's {planner_launches}")
        steps = check_tuned_steps(tj)
        n_before = len(perfdb.load(db))
        perf_diff.perf_main(["ingest", run_dir], out=io.StringIO())
        tuned = {r["kernel"]: r["metrics"] for r in perfdb.load(db)[n_before:]}
        _require(tuned["kernel.hist_cumsum"]["n"] == launches["hist_cumsum"],
                 f"tuned run's kernel row {tuned.get('kernel.hist_cumsum')}")
        buf = io.StringIO()
        diff = perf_diff.perf_main(["diff", untuned_run, run_dir,
                                    "--top", "8"], out=buf)
        k1 = [e for e in diff["entries"]
              if (e["kernel"], e["metric"]) == ("kernel.hist_cumsum", "n")]
        _require(len(k1) == 1 and k1[0]["a"] == untuned["hist_cumsum"]
                 and k1[0]["b"] == launches["hist_cumsum"],
                 f"perf diff of the planner runs: {diff['entries'][:4]}")

        perfdb.record_tuned("cuda", "serve", "serve",
                            {"serve_buckets": list(RECORDED_BUCKETS)},
                            {"p99_ms": 1.0})
        _reset_counts()
        svc = ScoringService(registry)
        svc.start()
        try:
            warmed = _read_counts()
            values = check_served_values(svc, registry, feats,
                                         buckets=RECORDED_BUCKETS)
        finally:
            svc.stop()
        _require(svc.buckets == RECORDED_BUCKETS
                 and warmed == {"hist_cumsum": 0, "treeshap_unit":
                                len(registry) * len(RECORDED_BUCKETS)},
                 f"recorded buckets: {svc.buckets}, warm launches {warmed}")
        unit_rows = check_unit_rows(registry, feats, RECORDED_BUCKETS)
        os.environ[perfdb.DB_ENV] = os.path.join(tmp, "absent.jsonl")
        _require(resolve_buckets(None, "cuda") == DEFAULT_BUCKETS,
                 "bucket fall-through")
    finally:
        if saved is None:
            os.environ.pop(perfdb.DB_ENV, None)
        else:
            os.environ[perfdb.DB_ENV] = saved
    return {"perfdb_planner_untuned": untuned, "perfdb_planner": launches,
            "perfdb_serve": warmed}, {
        "rows_ingested": len(rows), "kernel_rows": kern,
        "tuned_node_batch": TUNED_NODE_BATCH, "tuned_wall_s": wall,
        "untuned_wall_s": untuned_wall, "untuned_launches": untuned,
        "tuned_launches": launches, "planner_launches": planner_launches,
        "tuned_steps": steps,
        "diff_top": buf.getvalue().splitlines()[:11],
        "serve_buckets": list(svc.buckets), "serve_warm_launches": warmed,
        "serve_values": values, "unit_rows": unit_rows}


def run_lockwatch_drill(tmp, plain):
    """The drain drill's child once more with ``F16_LOCKWATCH=<file>``:
    its dump must validate as the witness's document, hold the port's
    import-time locks (``kernels/build.py``, ``obs/core.py``) and the
    serving locks, and reconcile against an empty static model with no
    cycle. ``plain`` is the drill without the witness, from this call."""
    from flake16_framework_tpu_torch.obs import lockwatch, schema

    path = os.path.join(tmp, "lockwatch.json")
    rep = run_drain_drill(tmp, name="lockwatch",
                          env_extra={lockwatch.ENV_VAR: path})
    with open(path) as fd:
        dump = json.load(fd)
    root = os.path.dirname(os.path.abspath(__file__))
    rec = lockwatch.reconcile(dump, {"locks": {}, "edges": []}, root=root)
    sites = {os.path.relpath(s.rpartition(":")[0], root) for s in dump["locks"]}

    def rel(site):
        path, _, line = site.rpartition(":")
        return f"{os.path.relpath(path, root)}:{line}"

    want = {os.path.join("flake16_framework_tpu_torch", m) for m in (
        "kernels/build.py", "obs/core.py", "serve/batcher.py",
        "serve/queue.py", "serve/service.py")}
    _require(dump.get("schema") == schema.LOCKWATCH_SCHEMA
             and want <= sites and dump["edges"]
             and rec["ok"] and rec["cycle"] is None,
             f"lockwatch dump: schema {dump.get('schema')}, missing "
             f"{sorted(want - sites)}, {len(dump['edges'])} edges, "
             f"reconcile {json.dumps(rec)[:300]}")
    return {"locks": len(dump["locks"]), "edges": len(dump["edges"]),
            "acquire_edges_total": sum(e[2] for e in dump["edges"]),
            "edge_sites": [[rel(a), rel(b), n] for a, b, n in dump["edges"]],
            "foreign_releases": dump["foreign_releases"],
            "reconcile": rec, "wall_s": rep["wall_s"],
            "ready_s": rep["ready_s"], "counts": rep["counts"],
            "plain_wall_s": plain["wall_s"],
            "plain_ready_s": plain["ready_s"]}


def print_new_phases(met, serve_load, pdb, lw, smi):
    ml = met["load"]
    print(f"metrics path ({smi}): {met['scrapes']} scrapes of "
          f"{met['series']} series, all valid (mean "
          f"{met['scrape_ms_mean']:.2f} ms, max {met['scrape_ms_max']:.2f} "
          f"ms a scrape); requests_total {met['requests_total']:.0f} == "
          f"completed, device memory peak {met['device_mem_peak_mb']:.1f} "
          f"MB; scraped {ml['rps']} rps, p99 {ml['p99_ms']} ms against "
          f"serve_path's {serve_load['rps']} rps, p99 "
          f"{serve_load['p99_ms']} ms", flush=True)
    print(f"perfdb path ({smi}): ingested {pdb['rows_ingested']} rows "
          f"(backend cuda), kernel rows {json.dumps(pdb['kernel_rows'])}; "
          f"scores planner at node_batch {pdb['tuned_node_batch']}: "
          f"{pdb['tuned_wall_s']:.2f} s, launches "
          f"{json.dumps(pdb['tuned_launches'])} against "
          f"{json.dumps(pdb['untuned_launches'])} in "
          f"{pdb['untuned_wall_s']:.2f} s untuned (the planner path's "
          f"{json.dumps(pdb['planner_launches'])}), scores == planner path; "
          f"recorded buckets {pdb['serve_buckets']} warmed with "
          f"{json.dumps(pdb['serve_warm_launches'])}", flush=True)
    ts = pdb["tuned_steps"]
    print(f"hist_cumsum fold-batched steps {ts['config']} at W = "
          f"{ts['window']} ({ts['trees']} trees, {ts['groups']} groups): "
          f"{ts['steps']} steps, bitwise == plain and repeatable on every "
          f"step", flush=True)
    worst = {k: max(r[k] for r in pdb["serve_values"]) for k in (
        "predict_max_abs_err", "shap_max_abs_err", "local_accuracy_max_err")}
    print(f"perfdb path served values at buckets {pdb['serve_buckets']}: "
          f"{json.dumps(worst)}; treeshap_unit serving rows "
          + ", ".join(f"S = {r['samples']} err {r['max_abs_err']:.3g} (max "
                      f"{r['max_abs_plain']:.3g})" for r in pdb["unit_rows"])
          + " against unit_shap_plain", flush=True)
    for line in pdb["diff_top"]:
        print(f"perf diff: {line}", flush=True)
    print(f"lockwatch drill ({smi}): {lw['locks']} lock sites, "
          f"{lw['edges']} order edges ({lw['acquire_edges_total']} nested "
          f"acquisitions: {json.dumps(lw['edge_sites'])}), no cycle; child "
          f"wall {lw['wall_s']:.2f} s "
          f"(ready {lw['ready_s']:.2f} s) against {lw['plain_wall_s']:.2f} s"
          f" (ready {lw['plain_ready_s']:.2f} s) without the witness; "
          f"requests {json.dumps(lw['counts'])}", flush=True)


def print_telemetry(tel, launches, smi):
    sums, prof = tel["span_launches"], tel["profiles"]
    print(f"telemetry path ({smi}): child {tel['child_s']:.1f} s, scores == "
          f"scores path, every event valid, backend cuda; report --json "
          f"(valid), --attrib, trace ({tel['trace_events']} spans) read the "
          f"run; span launches {json.dumps(sums)} == counted; launches "
          f"{launches}", flush=True)
    for name, p in prof.items():
        print(f"telemetry profile {name}: {p['kernel_slices']} kernel "
              f"slices, K1 {p['hist_cumsum']}, K2 {p['treeshap_unit']} == "
              f"the wrappers' counts; device {p['device_s']:.3f} s; trace "
              f"{p['trace_mb']:.1f} MB", flush=True)
    walls = tel["walls"]
    for keys in walls["runs"][0]["walls_s"]:
        row = " ".join(f"{r['telemetry']} {r['walls_s'][keys]:.3f}"
                       for r in walls["runs"])
        print(f"telemetry walls {keys} ({smi}): {row}; with profile= "
              f"{tel['profiled_config_walls_s'][keys]:.3f} s", flush=True)
    print(f"telemetry walls ({smi}): sums "
          f"{[round(r['sum_s'], 4) for r in walls['runs']]} (on off off "
          f"on), on/off by pair {[round(x, 4) for x in walls['on_over_off']]}",
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # No performance database outside ``perfdb_path`` (which points it at
    # a fresh file): a row left in the checkout's default file would
    # change the other phases' windows, ladders and launch counts. The
    # drills' and the fleet's children inherit the setting.
    os.environ["F16_PERFDB"] = "0"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from flake16_framework_tpu_torch.kernels import build
    from flake16_framework_tpu_torch.utils.synth import make_tests_json

    phases, mark = {}, [time.time()]

    def lap(name):
        now = time.time()
        phases[name] = now - mark[0]
        mark[0] = now

    names = ("hist_cumsum", "treeshap_unit")
    t0 = time.time()
    logs = build.build(*names)
    for name in names:
        build.load(name)
    build_s = time.time() - t0
    print(f"build: {build_s:.2f} s for {', '.join(names)} (in parallel)",
          flush=True)
    for name in names:
        print(f"nvcc {name}: {logs[name].strip()}", flush=True)

    lap("build")
    k1 = check_hist_kernel()
    lap("hist_cumsum_full_window")
    print(f"hist_cumsum bitwise == plain and repeatable; kernel "
          f"{k1['ms']:.4f} ms back to back (device time "
          f"{k1['device_ms']:.4f} ms, host {k1['host_ms_per_call']:.4f} "
          f"ms a call, queued {k1['queued']}), plain "
          f"{k1['plain_ms']:.3f} ms, library {k1['library_ms']:.3f} ms, "
          f"bound {k1['bound_ms']:.4f} ms ({k1['bound_by']})", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        tj = os.path.join(tmp, "tests.json")
        make_tests_json(tj, n_tests=N_TESTS, n_projects=N_PROJECTS, seed=0)
        k2 = check_unit_kernel(tj)
        lap("treeshap_unit_buckets")
        for b in k2["buckets"]:
            print(f"treeshap_unit {b['config']} cap {b['cap']}: "
                  f"{b['paths']} paths (mean u {b['mean_u']:.2f}, o = 1 "
                  f"{b['o1_share']:.3f}) x {k2['samples']} samples, err "
                  f"{b['max_abs_err']:.3g} (max {b['max_abs_plain']:.3g}), "
                  f"kernel {b['ms']:.4f} ms, plain {b['plain_ms']:.3f} ms, "
                  f"{b['bound_share']:.1%} of bound", flush=True)
        for name, c in k2["per_config"].items():
            print(f"treeshap_unit {name}: {c['ms']:.4f} ms over "
                  f"{c['buckets']} buckets, plain {c['plain_ms']:.3f} ms, "
                  f"bound {c['bound_ms']:.4f} ms ({c['bound_share']:.1%}; "
                  f"division-form bound {c['bound_ms_division']:.4f} ms)",
                  flush=True)
        print(f"treeshap_unit: {k2['ms']:.4f} ms over both configs, bound "
              f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}), "
              f"division-form bound {k2['bound_ms_division']:.4f} ms",
              flush=True)
        real = check_real_steps(tj)
        lap("hist_cumsum_real_steps")
        for r in real:
            print(f"hist_cumsum real steps {r['config']}: {r['steps']} "
                  f"steps, {r['sum_ms']:.4f} ms back to back in all "
                  f"({r['mean_ms']:.4f} ms a step; device time "
                  f"{r['device_sum_ms']:.4f} ms, host "
                  f"{r['host_ms_per_call']:.4f} ms a call, queued "
                  f"{r['queued']}), bound {r['bound_sum_ms']:.4f} ms "
                  f"({r['bound_share']:.1%}; of device time "
                  f"{r['device_bound_share']:.1%}), in-window share "
                  f"{r['in_window_share_mean']:.3f}, occupied rows "
                  f"{r['rows_mean']:.1f} of {NODE_BATCH}, "
                  f"{r['steps_le_16_rows']} steps with <= 16; bitwise == "
                  f"plain and repeatable on every step", flush=True)
        small = check_small_reference()
        lap("small_reference")
        print(f"small reference: {small}", flush=True)
        exact = check_exact_fold(tj)
        lap("exact_fold")
        print(f"exact grower {exact['config']} fold 0: card forest bitwise "
              f"== CPU, {exact['n_nodes']} nodes, {exact['levels']} levels "
              f"(host reads) over {exact['live_samples']} live of "
              f"{exact['samples']} rows; fit {exact['wall_ms']:.1f} ms "
              f"({exact['wall_ms_per_level']:.2f} ms a level), "
              f"{exact['kernel_launches']} launches "
              f"({exact['launches_per_level']:.1f} a level), busy "
              f"{exact['device_busy_ms']:.2f} ms, idle "
              f"{exact['device_idle_share']:.1%}", flush=True)

        score_launches, configs, journal, ref = run_scores_path(tmp, tj)
        lap("scores_path")
        for c in configs:
            print(f"config {c['config']}: wall {c['wall_s']:.2f} s, "
                  f"hist_cumsum launches {c['hist_cumsum_launches']}, "
                  f"F1 {c['f1']}, (FP, FN, TP) {c['counts_fp_fn_tp']}",
                  flush=True)
        print(f"scores path launches: {score_launches}; journal "
              f"{journal['n_appends']} appends in "
              f"{journal['append_wall_s']:.6f} s of "
              f"{journal['sweep_wall_s']:.3f} s "
              f"({journal['append_share']:.3%})", flush=True)
        tel_launches, tel, tel_shap = run_telemetry_path(tmp, tj, ref)
        lap("telemetry_path")
        tel["walls"] = time_telemetry(tmp, tj)
        lap("telemetry_walls")
        print_telemetry(tel, tel_launches, smi)
        planner_launches, members, pjournal, pwall = run_planner_path(
            tmp, tj, ref)
        lap("planner_path")
        for m in members:
            print(f"planner member {m['config']} ({smi}): wall "
                  f"{m['wall_s']:.3f} s, hist_cumsum launches "
                  f"{m['hist_cumsum_launches']}, host reads "
                  f"{m['host_reads']}, peak allocated "
                  f"{m['peak_allocated_gb']:.2f} GB", flush=True)
        print(f"planner path launches: {planner_launches}, wall "
              f"{pwall:.2f} s; journal {pjournal['n_appends']} appends in "
              f"{pjournal['append_wall_s']:.6f} s of "
              f"{pjournal['sweep_wall_s']:.3f} s; scores == scores path",
              flush=True)
        batched = check_batched_steps(tj)
        lap("hist_cumsum_batched_steps")
        print(f"hist_cumsum fold-batched steps {batched['config']} "
              f"({batched['trees']} trees, {batched['groups']} groups): "
              f"{batched['steps']} steps, {batched['sum_ms']:.4f} ms back "
              f"to back ({batched['mean_ms']:.4f} ms a step; device time "
              f"{batched['device_sum_ms']:.4f} ms, queued "
              f"{batched['queued']}), bound {batched['bound_sum_ms']:.4f} "
              f"ms ({batched['bound_share']:.1%}; of device time "
              f"{batched['device_bound_share']:.1%}), in-window share "
              f"{batched['in_window_share_mean']:.3f}, occupied rows "
              f"{batched['rows_mean']:.1f}; bitwise == plain and "
              f"repeatable on every step", flush=True)
        kill = run_kill_drill(tmp, ref)
        lap("kill_drill")
        kj = kill["journal"]
        print(f"kill drill: restart events {kill['restart_events']}, flight "
              f"dump {kill['flight_dump_records']} records; deaths "
              f"{kill['deaths']}, final rc {kill['rc']}, "
              f"replayed {kill['replayed_configs']} config(s) and "
              f"{kill['replayed_folds']} fold(s), resumed child launches "
              f"{kill['resumed_child_launches']}, scores == uninterrupted; "
              f"resumed child's journal n_appends {kj['n_appends']} "
              f"append_wall_s {kj['append_wall_s']:.6f} of "
              f"{kj['sweep_wall_s']:.3f} s ({kj['append_share']:.3%})",
              flush=True)
        sticky = run_sticky_fault_drill(tmp, ref)
        lap("sticky_fault_drill")
        print(f"sticky fault: exit {sticky['rc']}, sidecar "
              f"{json.dumps(sticky['sidecar'])}, in the pickle "
              f"{sticky['in_pickle_after_fault']}; resume exit "
              f"{sticky['resume_rc']}, scores == uninterrupted", flush=True)
        oom = run_oom_drill()
        lap("oom_drill")
        print(f"oom drill: {oom['attempts']} attempts, retries "
              f"{json.dumps(oom['retries'])}, K1 bitwise == direct call",
              flush=True)
        lopo_launches, lopo_cfgs, lopo_wall = run_lopo_path(tmp, tj)
        lap("lopo_path")
        for c in lopo_cfgs:
            print(f"lopo {c['config']}: wall {c['wall_s']:.2f} s "
                  f"({N_PROJECTS} folds), hist_cumsum launches "
                  f"{c['hist_cumsum_launches']}, F1 {c['f1']}, (FP, FN, TP) "
                  f"{c['counts_fp_fn_tp']}", flush=True)
        print(f"lopo path launches: {lopo_launches}, wall {lopo_wall:.2f} s",
              flush=True)
        shap_launches, shap_cfgs, shap_wall = run_shap_path(tmp, tj)
        lap("shap_path")
        for c in shap_cfgs:
            print(f"shap {c['config']}: fit {c['fit_s']:.2f} s, explain "
                  f"{c['explain_s']:.2f} s, local accuracy max err "
                  f"{c['local_accuracy_max_err']:.3g}", flush=True)
        print(f"shap path launches: {shap_launches}, wall {shap_wall:.2f} s",
              flush=True)
        tel["shap_max_abs_diff"] = check_telemetry_shap(
            tel_shap, os.path.join(tmp, "shap.pkl"))
        print(f"telemetry path SHAP values bitwise == shap path's (max "
              f"diff {tel['shap_max_abs_diff']})", flush=True)
        grid_launches, grid_rows, grid_modes, grid_members = \
            run_shap_grid_path(tmp, tj)
        lap("shap_grid_path")
        for r in grid_rows:
            check = r.get("local_accuracy_max_err",
                          r.get("row_sum_vs_path_max_err"))
            print(f"shap_grid {r['mode']} {r['config']} ({smi}): fit "
                  f"{r['fit_s']:.3f} s, explain {r['explain_s']:.3f} s, peak "
                  f"allocated {r['peak_allocated_gb']:.2f} GB, "
                  f"{r['n_nodes_max']} nodes at most, check err "
                  f"{check:.3g}", flush=True)
        for mode, m in grid_modes.items():
            print(f"shap_grid {mode}: wall {m['wall_s']:.2f} s for "
                  f"{len(GRID_CONFIGS)} configs, launches {m['launches']}",
                  flush=True)
        print(f"shap_grid path launches: {grid_launches}", flush=True)
        k2_grid = unit_report(grid_members)
        lap("treeshap_unit_s64")
        for name, c in k2_grid["per_config"].items():
            print(f"treeshap_unit at S = {k2_grid['samples']} {name} "
                  f"({smi}): {c['ms']:.4f} ms over {c['buckets']} buckets, "
                  f"plain {c['plain_ms']:.3f} ms, bound {c['bound_ms']:.4f} "
                  f"ms ({c['bound_share']:.1%})", flush=True)
        print(f"treeshap_unit at S = {k2_grid['samples']}: "
              f"{k2_grid['ms']:.4f} ms, plain {k2_grid['plain_ms']:.3f} ms, "
              f"bound {k2_grid['bound_ms']:.4f} ms ({k2_grid['bound_by']}), "
              f"max err {k2_grid['max_abs_err']:.3g}", flush=True)
        explains = profile_explains(grid_members)
        lap("shap_grid_profiles")
        for e in explains:
            top = e["top_kernels"][0]
            print(f"explain profile {e['mode']} {e['config']} ({smi}): wall "
                  f"{e['wall_s']:.3f} s, {e['kernel_launches']} launches, "
                  f"busy {e['device_busy_ms']:.1f} ms, idle "
                  f"{e['device_idle_share']:.1%}; top {top['name'][:60]} "
                  f"{top['ms']:.1f} ms over {top['count']}", flush=True)
        serve_launches, serve, svc, serve_reg, serve_feats = \
            run_serve_path(tmp, tj)
        try:
            lap("serve_path")
            serve["values"] = check_served_values(svc, serve_reg,
                                                  serve_feats)
            serve["treeshap_unit"] = serve_unit_report(serve_reg,
                                                       serve_feats)
            lap("serve_checks")
        finally:
            svc.stop()
        metrics_launches, met = run_metrics_path(serve_reg, serve_feats)
        lap("metrics_path")
        serve["drain_drill"] = run_drain_drill(tmp)
        lap("serve_drain_drill")
        lw = run_lockwatch_drill(tmp, serve["drain_drill"])
        lap("lockwatch_drill")
        perfdb_launches, pdb = run_perfdb_path(
            tmp, tj, tel, tel_launches, planner_launches, serve_reg,
            serve_feats)
        lap("perfdb_path")
        print_new_phases(met, serve["load"], pdb, lw, smi)
        fleet_launches, fleet_rep, fleet_answers = run_fleet_path(
            tmp, serve_reg, serve_feats)
        fleet_rep["values"] = check_fleet_values(fleet_answers, serve_reg,
                                                 serve_feats)
        lap("fleet_path")
        drill = run_fleet_drill(tmp, serve_reg, serve_feats)
        lap("fleet_drill")
        load = serve["load"]
        print(f"serve path ({smi}): registered {len(GRID_CONFIGS)} models "
              f"in {serve['register_s']:.2f} s (K1 "
              f"{serve['register_launches']['hist_cumsum']} launches, peak "
              f"allocated {serve['peak_allocated_gb_register']:.2f} GB), "
              f"warm {serve['warm_s']:.3f} s (K2 "
              f"{serve['warm_launches']['treeshap_unit']} launches); load "
              f"{load['requests']} requests of {load['rows']} rows from "
              f"{load['clients']} clients in {load['wall_s']:.3f} s, "
              f"{load['rps']} rps, p50 {load['p50_ms']} ms, p99 "
              f"{load['p99_ms']} ms, n_errors {load['n_errors']}, peak "
              f"allocated {serve['peak_allocated_gb_load']:.3f} GB; "
              f"launches {serve_launches}", flush=True)
        for kind, k in serve["by_kind"].items():
            print(f"serve {kind} ({smi}): {k['requests']} requests, "
                  f"{k['rps']:.1f} rps, p50 {k['p50_ms']:.3f} ms, p99 "
                  f"{k['p99_ms']:.3f} ms (client side), {k['dispatches']} "
                  f"microbatches", flush=True)
        worst = {k: max(r[k] for r in serve["values"]) for k in (
            "predict_max_abs_err", "shap_max_abs_err",
            "local_accuracy_max_err")}
        print(f"serve values: each model, kind and bucket against the direct "
              f"call: {json.dumps(worst)}", flush=True)
        chk = serve["treeshap_unit"]["check"]
        print(f"treeshap_unit serving rows {chk['config']}: {chk['rows']} "
              f"rows x {chk['samples']} samples, err {chk['max_abs_err']:.3g} "
              f"(max {chk['max_abs_plain']:.3g}) against unit_shap_plain",
              flush=True)
        for t in serve["treeshap_unit"]["timings"]:
            print(f"treeshap_unit serving {t['config']} S = {t['samples']} "
                  f"({smi}): {t['ms']:.4f} ms over {t['rows']} rows "
                  f"({t['live_rows']} live, mean u {t['mean_live_u']:.2f}), "
                  f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} "
                  f"ms ({t['bound_by']}, {t['bound_share']:.1%})",
                  flush=True)
        d = serve["drain_drill"]
        print(f"drain drill ({smi}): child exit {d['rc']}, ready after "
              f"{d['ready_s']:.1f} s, drain {json.dumps(d['drain'])}, "
              f"requests {json.dumps(d['counts'])}; manifest == reloaded "
              f"store's warm_manifest", flush=True)
        print_fleet(fleet_rep, fleet_launches, drill, smi)
        by_name = {c["config"]: c for c in configs}
        prof = []
        for k in MAIN_CONFIGS + DT_CONFIGS[:1]:
            c = by_name["/".join(k)]
            prof.append(profile_config(tj, k, 10 * (
                c["t_train_per_fold_s"] + c["t_test_per_fold_s"])))
        member_prof = [profile_member(tj, tuple(m["config"].split("/")),
                                      m["wall_s"]) for m in members]
    lap("profiles")
    print(f"phases (s): {json.dumps(phases)}", flush=True)
    for p in prof:
        share = p["hist_share_of_device"]
        print(f"profile {p['config']}: {p['kernel_launches']} launches, "
              f"busy {p['device_busy_ms']:.1f} ms, idle "
              f"{p['device_idle_share']:.1%}, hist_cumsum "
              f"{p['hist_cumsum_ms']:.2f} ms over "
              f"{p['hist_cumsum_launches']} launches ({share:.1%} of device "
              f"time), exact-grower levels {p['levels']}", flush=True)
        print(f"profile: {json.dumps(p)}", flush=True)
    for p in member_prof:
        share = p["hist_share_of_device"]
        print(f"planner member profile {p['config']} ({smi}): "
              f"{p['kernel_launches']} launches, busy "
              f"{p['device_busy_ms']:.1f} ms, idle "
              f"{p['device_idle_share']:.1%} of "
              f"{p['wall_s_unprofiled']:.3f} s, hist_cumsum "
              f"{p['hist_cumsum_ms']:.2f} ms over "
              f"{p['hist_cumsum_launches']} launches"
              + (f" ({share:.1%} of device time)" if share else ""),
              flush=True)

    paths = {"scores": score_launches, "telemetry": tel_launches,
             "planner": planner_launches,
             "lopo": lopo_launches,
             "shap": shap_launches, "shap_grid": grid_launches,
             "serve": serve_launches, "fleet": fleet_launches,
             "kill_drill_resumed_child": kill["resumed_child_launches"],
             "metrics": metrics_launches, **perfdb_launches}
    k1["launches"] = sum(p["hist_cumsum"] for p in paths.values())
    k2["launches"] = sum(p["treeshap_unit"] for p in paths.values())
    kernels = {"kernels": [{k: kern[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for kern in (k1, k2)]}
    report = {"nvidia_smi": smi, "build_s": build_s, "nvcc": logs,
              "kernels": [k1, k2], "launches_by_path": paths,
              "hist_real_steps": real,
              "small_reference": small, "exact_fold": exact,
              "scores_path": configs, "scores_path_journal": journal,
              "telemetry_path": tel,
              "planner_path": members, "planner_path_wall_s": pwall,
              "planner_path_journal": pjournal,
              "hist_batched_steps": batched, "planner_profile": member_prof,
              "kill_drill": kill, "sticky_fault_drill": sticky,
              "oom_drill": oom, "lopo_path": lopo_cfgs,
              "lopo_path_wall_s": lopo_wall, "shap_path": shap_cfgs,
              "shap_path_wall_s": shap_wall, "shap_grid_path": grid_rows,
              "shap_grid_modes": grid_modes, "treeshap_unit_s64": k2_grid,
              "shap_grid_explain_profiles": explains, "serve_path": serve,
              "fleet_path": fleet_rep, "fleet_drill": drill,
              "metrics_path": met, "perfdb_path": pdb,
              "lockwatch_drill": lw,
              "profile": prof, "phases_s": phases,
              "torch": torch.__version__,
              "cuda": torch.version.cuda}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fd:
        json.dump(report, fd, indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
