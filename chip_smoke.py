"""Chip smoke of the PyTorch/CUDA port (flake16_framework_tpu_torch) on one
NVIDIA H100: builds the CUDA kernels from ``csrc/`` (and the collation's
host C++, ``native/collate_fast.cc``, with g++), holds each against its
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
first ensemble config and the first Decision Tree config then run once
more under the profiler, for the kernels' shares of device time.

``model_arms`` runs the JAX package's model-changing arms at full width
(100 trees, depth 48), each through ``SweepEngine.run_config`` under its
``F16_*`` variable on one config of the family it applies to: the RF
scores config at 32 and 48 bins (``F16_HIST_BINS``), under
``F16_HIST_REFINE=edge`` and ``F16_FEATURE_QUOTA=sklearn``; the ET scores
config under ``F16_ET_DRAW=rank`` and ``F16_PCA_IMPL=eigh``; and the
Decision Tree ``NOD/Flake16/None/None`` under ``F16_FEATURE_QUOTA=
sklearn`` (all features are a single tree's quota, so its counts must
equal its default's). Each arm prints its F1 beside the default's, K1's
launches and the wall; fold 0's forest of each arm, from the sweep's
own tensors at 2 trees, must be bitwise equal on the card and on the
CPU; K1 is held bitwise against its plain version on every real BFS
step of fold 0's fit at 32 and 48 bins and on synthetic full windows at
128 and 256 bins (113 and 56 nodes, the widest its shared memory
holds); the eigh arm's (FP, FN, TP) must stay within 6 samples of svd's
(the JAX package's bound). ``parity_full`` runs the port's sklearn
parity oracle (``perf/parity.py``) at its full tier in this process: N
= 4000, 100 trees, 6 seeds of the RF and ET probe configs and one of the
deterministic Decision Tree, against the committed
``parity_sklearn_n4000_t100.json``. The cache must validate, every seed
must run and RF and ET must launch K1; each config's delta, SE and +/-0.01
verdict are printed with the card's name and power limit, and a verdict
outside the tolerance is a finding this script reports, not a failure.

The ``telemetry_path`` phase runs the scores path's RF config and the
``shap`` verb on the paper configs once more, in a child process with
telemetry on (``F16_TELEMETRY``) and ``profile=``: its scores and SHAP
values must equal the untelemetered paths', every event and the manifest
be valid (backend ``cuda``, the card's name), ``report --json``,
``report --attrib`` and ``trace`` read the run, the fit and explain
spans' ``k1_launches``/``k2_launches`` sum to the wrappers' counts, and
each profile's CUDA kernel slices hold K1 and K2 as many times as the
wrappers counted, and ``report --attrib`` holds the entry points' ``cost``
events (``obs/costs.py``) and splits the fit into the grower's four
sub-stages. The RF config then runs four more times here,
telemetry on, off, off, on, for telemetry's cost to the config walls.
The card's scaler is held bitwise against the CPU's in the small
reference.

``scores planner`` (the plan executor) runs the same four configs as
three plans, each member's 10 folds grown as one tree batch; its scores
must equal the scores path's, and each member's wall, K1 launches, host
reads, peak memory and (profiled once more) idle share are printed. K1 is
held bitwise and timed on every fold-batched BFS step of the RF member
(1,000 trees reading 10 groups of bins). The planner path runs under
``F16_DEVICE_BUDGET_MB`` at the card's whole memory, so the sweep's
budget pre-flight passes it; ``budget_preflight`` then holds the memory
envelope (``parallel/envelope.py``, on ``cuda`` at the shape and width
each member ran) against each member's measured peak over the
allocation at its entry: at or above it, within 1.5 times for the RF and
ET members and 2 times for the Decision Trees. A child runs ``python -m
flake16_framework_tpu_torch scores planner`` on the whole grid in a
directory holding only the synthetic ``tests.json``, under a budget
between the Decision Tree plans' envelope and the hist plans': it must
exit non-zero with ``PlanOverBudget`` naming exactly the four hist plans
at the envelopes computed here, launch no K1, and leave no ``scores.pkl``
and no journal record.

``config_batch_path`` runs the config-batched sweep (the JAX package's
mesh path) on one card: four Decision Trees as one batch with a journal
(``run_grid(batch_size=4)``: 40 exact trees, one level serving every
config) and two Random Forests whose preprocessing (None, PCA) gives them
different bin edges as one batch (2 x 10 x 100 trees in tree batches of
1,000 over 20 groups through K1), each after the same configs through
``run_config``: counts bitwise equal, walls, launches and peak memory
both ways, the DT batch's device idle share, and K1 bitwise against its
plain version on one recorded step of the RF batch. With more than one
card visible the DT batch also runs split across them.

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
warms it at buckets (8, 32, 128), which captures one CUDA graph a model,
kind and bucket (18, and none under the load), and drives 1024 requests
of 16 rows from 8 clients, predict and SHAP in turn (SHAP on K2 through
the single-bucket rows, one launch a microbatch, counted at each graph
replay); it holds each model, kind and bucket against the direct call,
each graph's replay against its eager body (predict bitwise, SHAP within
SHAP_TOL and against ``unit_shap_plain`` on the live rows), two threads
replaying one graph, a reload capturing again, times the eager body
against the replay at each kind and bucket in turns, K2 on the ET
model's serving rows against its plain version, times K2 at S = 8, 32
and 128, and runs the drain drill: the
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
port makes at import time and the serving locks, and has no cycle. A
second witnessed child heals a torn performance database under telemetry
(``perfdb.append`` cuts the tail under ``_append_lock`` and emits the
truncation under ``obs/core``'s ``_lock``): its dump must hold that edge,
one between two locks of the static model, which the serving drill's
dump (its one nested acquisition is inside ``logging``) lacks.
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

``tune_lint`` runs the autotuner and the lint on the card, in a fresh
database under the phase's temporary directory. ``tune --dry-run`` must
show the field on ``cuda`` for each of the three ensemble families of the
probe configs: the default width and 64 (the port registers no width
above K1's shared-memory window, so the JAX package's 256 is not in
it), then 32 and 48 bins, which ``--no-parity-knobs`` leaves out. ``tune
--n 4000 --trees 100 --family 'Flake16/Random Forest'
--no-parity-knobs`` then probes the first family's widths, each candidate a child process running the
family's probe configs as ``scores planner`` does (K1 at each width):
every probe must exit 0 with a finite wall (a failed probe fails the
phase, it does not lose), and its line carries the K1 launches of its
timed run. If the winner cleared the 2% floor, ``scores planner`` runs
the family's probe configs under the recorded row and without it: scores
bitwise equal, K1 launches at the tuned width and the default. ``lint``
over the
port's package must exit 0, and ``lint --concurrency``'s static lock
model (``analysis/concurrency.build_lock_model``) reconciles both
``lockwatch_drill`` dumps (``obs/lockwatch.reconcile``): no cycle, every
edge between the package's locks inside the static order, and at least
one such edge checked.

``audit_path`` follows ``tune_lint``, in a temporary directory with its
own performance database. ``python -m flake16_framework_tpu_torch audit
--json --per-family 2`` runs as a child process with a time limit, on
``cuda`` at the audit's defaults (n = 120, 2 trees, depth 8, 16
explained) over the first 2 configs of each family (12 of the grid's
216; every plan of the census still runs):
every real entry point under the recorder (``analysis/ir.py``): the plan
executors (``scores planner``'s ``run_grid`` and ``shap grid`` in each
mode), the serving entries and the SHAP engines. It must exit 0 with no
finding, the static census must equal the plan windows the executor
opened in both arms, K1 must launch in every hist-family plan entry and
in none of the Decision Tree scores entries, K2 in the path-mode SHAP
entries, ``shap.path`` and ``serve.shap``, and each entry's recorded peak
must be at most the allocator's own peak over its window. ``lint --ir
--per-family 2`` (the same audit folded into the lint) runs as a second
child, started with the first, and must exit 0. The audit's document then feeds the
tuner: ``perf ingest`` puts its envelopes (at the card's width, 128) into
the phase's database; ``tune --dry-run`` at the default memory cap vetoes
no width, and with the cap between the anchor envelope scaled to width
64 and to width 128 it vetoes 128 and keeps 64. A seeded entry
(``torch.histc`` on ``cuda``, then ``.cpu()``), recorded here, must raise
I201 (deterministic mode flags the op) and I101 (the move).

Two phases chain the collection stage (the ``setup``/``container``/
``run``/``tests`` layer, host code) into the card. ``collect_chain`` runs
the port's pytest plugins on a 28-test toy git subject (14 stable, 12
NOD, one OD pair) in pytest subprocesses, 4 baseline, 2 shuffle and 1
testinspect run, with the plugin selection of the port's container
command; collates the artifacts with the port's ``write_tests``, checks
the labels, runs ``write_scores`` on the card for an RF (K1) and a
Decision Tree config at full width (the card's scores equal to the
CPU's), ``write_shap`` on the card and ``write_figures`` on the result.
``collate_scale`` writes the plugins' artifacts of the synthetic dataset
at the study's run counts (2,500 + 2,500 + 1 runs a project; 400 tests
over 4 projects: 20,012 files, 2.1 M outcome lines) with the
generator of ``tests/torch_collect_cases.py``, checks that the native
collation module (``native/collate_fast.cc``) builds and loads here and
equals the plain Python bodies on the phase's own coverage databases,
times the two on them in turns (plain, native, native, plain: the numbits
decode and the coverage feature sums), runs ``python -m
flake16_framework_tpu_torch tests`` on them in a child process (its
output must equal the generator's expected ``tests.json``; wall and
lines/s printed), removes the data and runs
``write_scores`` on the card for ``MAIN_CONFIGS`` on the collated file.

``multiprocess_path`` runs the config batch across processes (the JAX
package's multi-host path) through the dry-run tool
(``tools/multihost_dryrun.py``) at full width: four Flake16 Extra Trees
configs without PCA (N = 4000 over 26 projects, 100 trees, 10 folds,
depth 48) as two ``gloo`` ranks of one card each, which share the one
H100 (``shared_card``), against the same batch in this process on the
card. The counts must be bitwise equal, K1 must launch in both ranks
and here, and each config's false negatives and true positives must sum
to the dataset's positives; each rank's wall, gather wall, K1 launches
and peak allocated memory, the one process's wall and the phase's wall
are printed.

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
import platform
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
# The telemetry phases' config: the scores path's RF config. The
# profiled run's device trace grows with the configs' kernel launches (830
# MB for all four, 364 MB for the RF and a DT config, written by the
# child and parsed here).
TELEMETRY_CONFIGS = MAIN_CONFIGS[:1]
# The configs profiled whole at the end of the run: one of each grower.
PROFILED_CONFIGS = (MAIN_CONFIGS[0], DT_CONFIGS[0])
# The whole-grid SHAP phase: the two paper SHAP configs (ET, RF) and a
# Decision Tree.
GRID_CONFIGS = (
    ("NOD", "Flake16", "Scaling", "SMOTE Tomek", "Extra Trees"),
    ("OD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
    DT_CONFIGS[0],
)
N_EXPLAIN, N_BACKGROUND = 64, 32
# The config-batched sweep's phase: four Decision Trees as one batch of
# the exact grower, and two Random Forests whose preprocessing (None,
# PCA) gives them different bin edges, as one batch of the hist grower.
BATCH_DT_CONFIGS = (
    ("NOD", "Flake16", "None", "None", "Decision Tree"),
    ("NOD", "Flake16", "Scaling", "SMOTE", "Decision Tree"),
    ("OD", "Flake16", "PCA", "Tomek Links", "Decision Tree"),
    ("OD", "Flake16", "Scaling", "ENN", "Decision Tree"),
)
BATCH_RF_CONFIGS = (
    ("NOD", "Flake16", "None", "SMOTE", "Random Forest"),
    ("NOD", "Flake16", "PCA", "SMOTE", "Random Forest"),
)
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
    """K1's least time on the card for these inputs, from the kernel's
    work (``kernels/hist.work``): each input read once ([T, N] int32 rel,
    f32 w and wy, [F, N] or [G, F, N] uint8 bins) and both [T, F, W, B]
    f32 outputs written once, over the memory rate, against the adds (two
    for each in-window sample of weight > 0 and feature, two an output
    element) over the f32 rate. Returns (ms, "bytes" or "operations")."""
    from flake16_framework_tpu_torch.kernels.hist import work

    wk = work(rel, w, bin_t, n_nodes, n_bins)
    bytes_ms = wk["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = wk["flops"] / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def synthetic_hist_inputs(n_bins=N_BINS, window=NODE_BATCH):
    """K1's inputs at a full window: one fold's 100 trees, N = cap =
    8000, F = 16, B = ``n_bins`` (64), W = ``window`` (128), integer
    bootstrap weights, and about 80% of the samples in the window, so
    that all its rows are occupied."""
    n_tree, n, n_feat = 100, 2 * N_TESTS, 16
    rs = np.random.RandomState(0)
    w = rs.poisson(1.0, size=(n_tree, n)).astype(np.float32)
    w[:, int(0.9 * n):] = 0.0                      # invalid capacity slots
    y = (rs.rand(n) < 0.5).astype(np.float32)
    rel = rs.randint(-1, window + window // 4,
                     size=(n_tree, n)).astype(np.int32)
    bins = rs.randint(0, n_bins, size=(n_feat, n)).astype(np.uint8)
    dev = torch.device("cuda")
    rel_t = torch.from_numpy(rel).to(dev)
    w_t = torch.from_numpy(w).to(dev)
    wy_t = w_t * torch.from_numpy(y).to(dev)
    bin_t = torch.from_numpy(bins).to(dev)
    return (rel_t, w_t, wy_t, bin_t, window, n_bins)


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
    timed on the same inputs, ``plain_ms`` on the one plain call that the
    kernel is held against (seconds a bucket at S = 4000); the bound is
    the operations of these inputs (``unit_ops``) or their bytes,
    whichever is larger."""
    from flake16_framework_tpu_torch.kernels.treeshap_unit import (
        one_counts, unit_ops, unit_shap, unit_shap_plain,
    )
    from flake16_framework_tpu_torch.ops.treeshap import bucket_inputs

    buckets = []
    for keys, forest, x in members:
        x = x.contiguous()
        for cap, args in bucket_inputs(forest, x.shape[1]):
            got = unit_shap(*args, x)
            again = unit_shap(*args, x)
            plain = []
            plain_ms = _cuda_ms(lambda: plain.append(
                unit_shap_plain(*args, x)), reps=1, warm=0)
            want = plain.pop()
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
                "plain_ms": plain_ms,
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
    """``TELEMETRY_CONFIGS`` (the scores path's RF config) and the shap
    verb on the paper configs at full width, in
    a child process with telemetry on and ``profile=``: the scores equal
    the scores path's, every event and the manifest are valid (backend
    cuda, the card's name), ``report --json`` (valid), ``report
    --attrib`` and ``trace`` read the run, the fit spans'
    ``k1_launches`` and the explain spans' ``k1``/``k2_launches`` sum to the
    child's counts, and each profile's CUDA kernel slices hold K1 and K2
    as many times as the wrappers counted. Returns the launches, the
    report, and the child's ``shap.pkl`` (held against the shap path's
    later in the run)."""
    from flake16_framework_tpu_torch.obs import report, schema, trace

    out_dir = os.path.join(tmp, "telemetry")
    os.makedirs(out_dir)
    configs = TELEMETRY_CONFIGS
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
    costs = attrib["kernel_costs"]
    _require({"scores.fit", "shap.fused_fit", "shap.unit_pallas"}
             <= set(costs) and costs["scores.fit"]["flops"] > 0
             and {f"fit.{s}" for s in ("bin", "hist_build", "split_scan",
                                       "partition")} <= set(attrib["stages"]),
             f"attrib: stages {sorted(attrib['stages'])}, kernel costs "
             f"{sorted(costs)}")
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
        "attrib_stages": attrib["stages"], "attrib_kernel_costs": costs,
        "pass_s": {e["span"]: e.get("pass_s") for e in events
                   if e["kind"] == "cost"},
        "attrib_text_lines": len(attrib_text.getvalue().splitlines()),
        "trace_events": len(xs)}, os.path.join(out_dir, "shap.pkl")


def time_telemetry(tmp, tj):
    """``TELEMETRY_CONFIGS`` run four more times in this process,
    telemetry on, off, off, on (two pairs in turns): each config's wall
    (at its progress line) in each run, and each pair's on/off ratio of the
    configs' summed walls."""
    from flake16_framework_tpu_torch import obs

    configs = TELEMETRY_CONFIGS
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
        entry = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k1 = cum_hists.launches
        with _count_host_reads() as reads:
            t0 = time.perf_counter()
            out = real(self, keys)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        members.append({"config": "/".join(keys), "folds": self.n_folds,
                        "wall_s": wall,
                        "hist_cumsum_launches": cum_hists.launches - k1,
                        "host_reads": reads[0],
                        "peak_allocated_gb": peak / 1e9,
                        "peak_allocated_bytes": peak,
                        "entry_allocated_bytes": entry})
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


_BUDGET_CHILD = r"""
import json, runpy, sys
from flake16_framework_tpu_torch.kernels.hist import cum_hists
from flake16_framework_tpu_torch.kernels.treeshap_unit import unit_shap
sys.argv = ["flake16_framework_tpu_torch", "scores", "planner"]
try:
    runpy.run_module("flake16_framework_tpu_torch", run_name="__main__",
                     alter_sys=True)
finally:
    print("launches: " + json.dumps({"hist_cumsum": cum_hists.launches,
                                     "treeshap_unit": unit_shap.launches}),
          flush=True)
"""

# The envelope over a planner member's measured peak (``budget_preflight``).
LAW_LIMIT = {"hist": 1.5, "exact": 2.0}


def run_budget_preflight(tmp, tj, members):
    """The sweep's budget pre-flight on the card. (a) Each ``planner_path``
    member's envelope (``sweep.plan_envelope`` on ``cuda``, the member as
    a plan of one at N = 4000, 100 trees, depth 48, the default width
    128) against its measured peak over the allocation at its entry: the
    envelope's resident bytes are left out of the comparison, since the
    engine's labels and masks were allocated before the member (its
    32 MiB cuBLAS workspace stays in, though earlier phases made it). (b) A
    child ``python -m flake16_framework_tpu_torch scores planner`` over
    the whole grid (``_BUDGET_CHILD`` runs the module as ``-m`` does and
    prints K1's and K2's launches as the drills' children do), in a
    directory holding only ``tests.json``, with the budget halfway between
    the Decision Tree plans' envelopes and the hist plans': a non-zero
    exit with ``PlanOverBudget`` in its stderr naming exactly the four
    hist plans, each at the envelope computed here, no launch, no
    ``scores.pkl`` and no journal record. Returns the phase's record."""
    from flake16_framework_tpu_torch import config as cfg
    from flake16_framework_tpu_torch.parallel import planner, sweep
    from flake16_framework_tpu_torch.resilience import journal as rjournal

    def envelope(plan):
        return sweep.plan_envelope(plan, n_projects=N_PROJECTS,
                                   max_depth=48, grower=None,
                                   device_type="cuda", detail=True)

    rows = []
    for m in members:
        keys = tuple(m["config"].split("/"))
        env = envelope(planner.plan_grid([keys], n=N_TESTS, n_folds=10)[0])
        law = env["peak_bytes"] - env["arg_bytes"]
        measured = m["peak_allocated_bytes"] - m["entry_allocated_bytes"]
        grower = "exact" if keys[4] == "Decision Tree" else "hist"
        ratio = law / measured
        _require(1.0 <= ratio <= LAW_LIMIT[grower],
                 f"{m['config']}: envelope {law} B over measured {measured} "
                 f"B is {ratio:.4f}, outside [1, {LAW_LIMIT[grower]}]")
        rows.append({"config": m["config"], "law_bytes": law,
                     "measured_bytes": measured,
                     "entry_bytes": m["entry_allocated_bytes"],
                     "ratio": ratio, "law_phase": max(
                         env["phases"], key=env["phases"].get)})

    plans = planner.plan_grid([tuple(k) for k in cfg.iter_config_keys()],
                              n=N_TESTS, n_folds=10)
    mb = {"/".join(p.family): envelope(p)["peak_bytes"] / 2**20
          for p in plans}
    hist = {f for f in mb if not f.endswith("Decision Tree")}
    low = max(v for f, v in mb.items() if f not in hist)
    high = min(v for f, v in mb.items() if f in hist)
    _require(low < high, f"plan envelopes {mb}")
    budget = round((low + high) / 2, 1)
    run = os.path.join(tmp, "budget-child")
    os.makedirs(run)
    with open(tj, "rb") as src, \
            open(os.path.join(run, "tests.json"), "wb") as dst:
        dst.write(src.read())
    env = dict(os.environ, F16_DEVICE_BUDGET_MB=str(budget),
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.time()
    child = subprocess.run([sys.executable, "-c", _BUDGET_CHILD], cwd=run,
                           env=env, capture_output=True, text=True,
                           timeout=300)
    wall = time.time() - t0
    named = re.findall(r"(?:: |; )([A-Za-z0-9]+/[A-Za-z ]+) \(batch=36\): "
                       r"peak ([0-9.]+) MB", child.stderr)
    _require(child.returncode != 0 and "PlanOverBudget" in child.stderr,
             f"budget child: exit {child.returncode}\n{child.stderr[-3000:]}")
    _require(f"plan pre-flight: {len(hist)} of {len(plans)} family "
             f"program(s) exceed the F16_DEVICE_BUDGET_MB={budget:g} device "
             f"budget: " in child.stderr, f"budget child: {child.stderr}")
    _require({f for f, _ in named} == hist and all(
        f"{mb[f]:.1f}" == v for f, v in named),
        f"budget child named {named}, want {sorted(hist)} at {mb}")
    launches = json.loads(child.stdout.rsplit("launches: ", 1)[1]
                          .splitlines()[0])
    _require(launches == {"hist_cumsum": 0, "treeshap_unit": 0},
             f"budget child launched {launches}")
    left = sorted(os.listdir(run))
    _require("scores.pkl" not in left, f"budget child left {left}")
    jpath = os.path.join(run, "scores.pkl.journal")
    rep = rjournal.replay(jpath, warn_out=io.StringIO()) \
        if os.path.exists(jpath) else None
    _require(rep is None or (not rep.ledger and not rep.partial),
             "budget child journaled a record")
    return {"members": rows, "plan_envelopes_mb": mb, "budget_mb": budget,
            "child_rc": child.returncode, "child_wall_s": wall,
            "child_launches": launches, "child_named": named,
            "child_left": left}


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


def _batch_engine(tests_file, **kw):
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    return SweepEngine(*tests_to_arrays(load_tests(tests_file)), **kw)


def _timed_grid(engine, configs, **kw):
    """(results, wall s, launches, peak allocated GB) of ``engine.run_grid
    (configs, **kw)``, the counts set to 0 just before and read after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.time()
    got = engine.run_grid(list(configs), **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    return got, wall, _read_counts(), \
        torch.cuda.max_memory_allocated() / 1e9


def _same_values(got, want, configs, what):
    for k in configs:
        _require(pickle.dumps(got[k][2:]) == pickle.dumps(want[k][2:]),
                 f"{what}: {'/'.join(k)} differs from run_config")


def run_config_batch_path(tmp, tj):
    """The config-batched sweep on one card at the paper's shape. Four
    Decision Trees as one batch (``run_grid(batch_size=4)``, a journal
    on: 40 exact trees, one level serving every config) and the two
    Random Forests as one batch (2 x 10 folds x 100 trees in tree batches
    of 50 under ``TREES_IN_FLIGHT``, each fold reading its config's bin
    edges), each after the same configs through ``run_config``: counts
    bitwise equal, walls, launches and peak memory both ways. The DT
    batch runs twice more without the journal, timed and under the
    profiler, for its device idle share and launches, and the first DT
    config once more through ``run_config`` under the profiler.
    One BFS step of the RF batch (the fifth K1 launch: 1,000 trees over
    20 groups) is held bitwise against ``cum_hists_plain``. With more
    than one card visible the DT batch also runs split across all of
    them; with one, the split is held on the CPU only (the CPU tests).
    Returns (the batches' launches, the report)."""
    from flake16_framework_tpu_torch import pipeline
    from flake16_framework_tpu_torch.device import default_devices
    from flake16_framework_tpu_torch.kernels.hist import (
        cum_hists, cum_hists_plain,
    )
    from flake16_framework_tpu_torch.ops import trees
    from flake16_framework_tpu_torch.resilience import journal as rjournal

    rep = {"cards": torch.cuda.device_count(), "parts_s": {}}
    launches = {"hist_cumsum": 0, "treeshap_unit": 0}
    mark = [time.time()]

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    def part(name):
        now = time.time()
        rep["parts_s"][name] = now - mark[0]
        mark[0] = now

    # DT: each through run_config, then one batch of four with a journal,
    # then the batch bare (no journal), timed and once more profiled.
    one = _batch_engine(tj)
    ref, ref_wall, ref_counts, ref_peak = _timed_grid(one, BATCH_DT_CONFIGS)
    part("dt_run_config")
    batch = _batch_engine(tj)
    path = os.path.join(tmp, "config_batch.journal")
    jr = rjournal.SweepJournal.open(path, pipeline._journal_fingerprint(
        batch, cv="stratified", max_depth=48, tree_overrides=None))
    batch.journal = jr
    try:
        opened, opened_s = jr.n_appends, jr.append_wall_s
        dt, dt_wall, dt_counts, dt_peak = _timed_grid(
            batch, BATCH_DT_CONFIGS, batch_size=4)
        n_appends = jr.n_appends - opened
        append_s = jr.append_wall_s - opened_s
    finally:
        jr.close(remove=True)
        batch.journal = None
    add(dt_counts)
    _require(batch.amortized_configs == set(BATCH_DT_CONFIGS),
             "the DT configs did not run as one batch")
    _require(n_appends == len(BATCH_DT_CONFIGS) * 11,
             f"{n_appends} journal appends for the DT batch")
    _same_values(dt, ref, BATCH_DT_CONFIGS, "DT batch")
    _require(dt_counts["hist_cumsum"] == 0 == ref_counts["hist_cumsum"],
             "a Decision Tree launched K1")
    part("dt_batch")
    torch.cuda.synchronize()
    t0 = time.time()
    batch.run_config_batch(BATCH_DT_CONFIGS)
    torch.cuda.synchronize()
    bare_wall = time.time() - t0
    # both traced on the device only
    kernels = _profiled(lambda: batch.run_config_batch(BATCH_DT_CONFIGS),
                        host=False)
    busy_ms = sum(k[0] for k in kernels)
    part("dt_batch_bare_and_profiled")
    # The first config alone through run_config, profiled: its launches
    # against the batch's (the four configs' take four times as long).
    one_launches = sum(k[2] for k in _profiled(
        lambda: one.run_config(BATCH_DT_CONFIGS[0]), host=False))
    part("dt_run_config_profiled")
    rep["dt"] = {
        "configs": ["/".join(k) for k in BATCH_DT_CONFIGS],
        "batch_wall_s": dt_wall, "per_config_wall_s": ref_wall,
        "journal_appends": n_appends, "journal_append_wall_s": append_s,
        "batch_bare_wall_s": bare_wall,
        "batch_launches": sum(k[2] for k in kernels),
        "first_run_config_launches": one_launches,
        "batch_device_busy_ms": busy_ms,
        "batch_device_idle_share": 1.0 - busy_ms / 1e3 / bare_wall,
        "batch_peak_allocated_gb": dt_peak,
        "per_config_peak_allocated_gb": ref_peak}

    # RF: one batch of two (None, PCA), one BFS step recorded from it.
    step = []
    real = trees.cum_hists
    seen = [0]

    def recorder(rel, w, wy, bin_t, n_nodes, n_bins):
        seen[0] += 1
        if seen[0] == 5:
            step.extend([rel.clone(), w.clone(), wy.clone(), bin_t.clone(),
                         n_nodes, n_bins])
        return real(rel, w, wy, bin_t, n_nodes, n_bins)

    ref, ref_wall, ref_counts, ref_peak = _timed_grid(one, BATCH_RF_CONFIGS)
    part("rf_run_config")
    trees.cum_hists = recorder
    try:
        rf, rf_wall, rf_counts, rf_peak = _timed_grid(
            batch, BATCH_RF_CONFIGS, batch_size=2)
    finally:
        trees.cum_hists = real
    add(rf_counts)
    part("rf_batch")
    _require(set(BATCH_RF_CONFIGS) <= batch.amortized_configs,
             "the RF configs did not run as one batch")
    _same_values(rf, ref, BATCH_RF_CONFIGS, "RF batch")
    _require(rf_counts["hist_cumsum"] > 0, "the RF batch launched no K1")
    rep["rf"] = {
        "configs": ["/".join(k) for k in BATCH_RF_CONFIGS],
        "batch_wall_s": rf_wall, "per_config_wall_s": ref_wall,
        "batch_k1_launches": rf_counts["hist_cumsum"],
        "per_config_k1_launches": ref_counts["hist_cumsum"],
        "batch_peak_allocated_gb": rf_peak,
        "per_config_peak_allocated_gb": ref_peak}

    # K1 on the recorded step, against its plain version.
    _require(step, "no fifth BFS step in the RF batch")
    trees_in, groups = int(step[0].shape[0]), int(step[3].shape[0])
    _require(groups == 20, f"the recorded step has {groups} groups")
    got = cum_hists(*step)
    want = cum_hists_plain(*step)
    _require(all(torch.equal(a, b) for a, b in zip(got, want)),
             "hist_cumsum differs from plain on a config-batched step")
    rep["k1_step"] = {"trees": trees_in, "groups": groups,
                      "max_abs_err": max(float((a - b).abs().max())
                                         for a, b in zip(got, want))}
    del got, want, step
    part("k1_step")

    if rep["cards"] > 1:
        split = _batch_engine(tj, devices=default_devices())
        got, wall, counts, _ = _timed_grid(split, BATCH_DT_CONFIGS)
        _same_values(got, dt, BATCH_DT_CONFIGS, "DT batch across cards")
        add(counts)
        rep["split_wall_s"] = wall
    return launches, rep


def print_config_batch(cb, launches, smi):
    dt, rf = cb["dt"], cb["rf"]
    print(f"config_batch DT ({smi}): {len(dt['configs'])} configs as one "
          f"batch {dt['batch_wall_s']:.3f} s (journal "
          f"{dt['journal_appends']} appends in "
          f"{dt['journal_append_wall_s']:.3f} s) against run_config "
          f"{dt['per_config_wall_s']:.3f} s, bitwise equal; bare batch "
          f"{dt['batch_bare_wall_s']:.3f} s, {dt['batch_launches']} "
          f"launches for four configs against run_config's "
          f"{dt['first_run_config_launches']} for the first, "
          f"busy {dt['batch_device_busy_ms']:.1f} ms, idle "
          f"{dt['batch_device_idle_share']:.1%}; peak allocated "
          f"{dt['batch_peak_allocated_gb']:.3f} GB against "
          f"{dt['per_config_peak_allocated_gb']:.3f} GB", flush=True)
    print(f"config_batch RF ({smi}): None and PCA as one batch "
          f"{rf['batch_wall_s']:.3f} s against run_config "
          f"{rf['per_config_wall_s']:.3f} s, bitwise equal; K1 "
          f"{rf['batch_k1_launches']} launches against "
          f"{rf['per_config_k1_launches']}; peak allocated "
          f"{rf['batch_peak_allocated_gb']:.3f} GB against "
          f"{rf['per_config_peak_allocated_gb']:.3f} GB", flush=True)
    k = cb["k1_step"]
    print(f"config_batch K1 step ({k['trees']} trees, {k['groups']} "
          f"groups): bitwise == plain; launches on the batches "
          f"{launches}; parts (s) {json.dumps(cb['parts_s'])}", flush=True)
    if cb["cards"] > 1:
        print(f"config_batch: {cb['cards']} cards visible; the DT batch "
              f"split across them in {cb['split_wall_s']:.3f} s, bitwise "
              f"equal", flush=True)
    else:
        print("config_batch: 1 card visible; the split across cards is "
              "held on the CPU only (tests/test_torch_configbatch.py)",
              flush=True)


def run_multiprocess_path(tmp):
    """The config batch across processes at full width, through the
    dry-run tool as ``python -m flake16_framework_tpu_torch.tools.
    multihost_dryrun --devices-per-proc 1 --batch 4`` runs it
    (``multihost_dryrun.run``): two ``gloo`` ranks of one card each,
    sharing the card when one is visible, then the same batch in this
    process. The kernels' counts are set to 0 just before and read just
    after; the ranks' K1 launches come from their own counts. Returns
    (the path's launches, the tool's line with the phase's wall)."""
    from flake16_framework_tpu_torch import config as cfg
    from flake16_framework_tpu_torch.tools import multihost_dryrun as mh

    args = mh.parse_args([
        "--devices-per-proc", "1", "--n", str(N_TESTS),
        "--projects", str(N_PROJECTS), "--trees", "100", "--depth", "48",
        "--batch", "4", "--timeout", "600",
        "--out", os.path.join(tmp, "multihost")])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # the ranks' room on a shared card
    _reset_counts()
    t0 = time.time()
    line = mh.run(args)
    line["phase_s"] = time.time() - t0
    here = _read_counts()
    failed = {k: line.get(k) for k in ("rank_rcs", "rank_errors")}
    _require(line["multihost_dryrun_ok"], f"multiprocess_path: "
             f"{json.dumps(failed)}, or the ranks' counts differ from one "
             f"process's")
    _require(line["shared_card"] == (torch.cuda.device_count() < 2),
             f"shared_card {line['shared_card']}")
    _require(all(n > 0 for n in line["rank_k1_launches"]),
             f"a rank launched no K1: {line['rank_k1_launches']}")
    _require(here["hist_cumsum"] == line["single_k1_launches"] > 0,
             f"one process's K1 launches {here}")
    _, labels, *_ = mh.dataset(N_TESTS, N_PROJECTS)
    for keys, counts in zip(mh.batch_configs(4), line["counts"]):
        counts = np.asarray(counts)
        _require(counts.shape == (N_PROJECTS, 3) and counts.min() >= 0,
                 f"counts of {keys}: shape {counts.shape}")
        positives = int((labels == cfg.FLAKY_TYPES[keys[0]]).sum())
        _require(int(counts[:, 1:].sum()) == positives,
                 f"{'/'.join(keys)}: FN + TP {counts[:, 1:].sum()} != "
                 f"{positives} positives")
    launches = {"hist_cumsum": here["hist_cumsum"] + sum(
        line["rank_k1_launches"]), "treeshap_unit": here["treeshap_unit"]}
    return launches, line


def print_multiprocess(mp, launches, smi):
    gb = [b / 1e9 for b in mp["rank_peak_allocated_bytes"]]
    for r in range(mp["procs"]):
        print(f"multiprocess_path rank {r} ({smi}): {mp['rank_devices'][r]}"
              f", wall {mp['rank_wall_s'][r]:.3f} s (gather "
              f"{mp['rank_gather_s'][r]:.3f} s), K1 "
              f"{mp['rank_k1_launches'][r]} launches, peak allocated "
              f"{gb[r]:.2f} GB", flush=True)
    print(f"multiprocess_path ({smi}): {mp['batch']} Extra Trees configs "
          f"over {mp['procs']} ranks x {mp['devices_per_proc']} card "
          f"(shared_card {mp['shared_card']}), ranks {mp['ranks_s']:.2f} s "
          f"from spawn to exit; one process {mp['single_wall_s']:.3f} s, "
          f"K1 {mp['single_k1_launches']} launches, peak allocated "
          f"{mp['single_peak_allocated_bytes'] / 1e9:.2f} GB; counts "
          f"bitwise equal; phase {mp['phase_s']:.2f} s; launches "
          f"{launches}", flush=True)


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
    res[0]["cext"] = check_cext(dict(results[0],
                                     config="/".join(SHAP_CONFIGS[0])))
    return launches, res, wall


def _cpu_model():
    """The host CPU: /proc/cpuinfo's model name, else its vendor, family
    and model, else ``lscpu``'s model name, else the machine type; with
    the cores this process may use."""
    info = {}
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as fd:
            for line in fd:
                key, _, value = line.partition(":")
                if value.strip() not in ("", "unknown"):
                    info.setdefault(key.strip(), value.strip())
    name = info.get("model name") or " ".join(
        f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model")
        if info.get(k))
    if not name:
        with contextlib.suppress(OSError, subprocess.SubprocessError):
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            name = next((line.split(":", 1)[1].strip()
                         for line in out.splitlines()
                         if line.startswith("Model name")), None)
    name = name or platform.processor() or platform.machine()
    return f"{name}, {len(os.sched_getaffinity(0))} cores"


def check_cext(result, n_samples=64):
    """The host C++ Tree SHAP baseline (``native/baseline.py``), built on
    this host, on one forest of the shap path converted from the port's
    ``Forest`` (f64, no rescaling) for ``n_samples`` of its samples,
    against K2's values (``treeshap.forest_shap_class0``) on the same
    forest and samples within SHAP_TOL of max|K2|. Walls: the module's
    build and load, the C++ call, and the K2 call's second run
    (synchronised). A record for a SHAP ratio against the card, not a
    claim."""
    from flake16_framework_tpu_torch import native
    from flake16_framework_tpu_torch.native import baseline
    from flake16_framework_tpu_torch.ops import treeshap, trees

    t_check = time.time()
    forest, x = result["forest"], result["x"][:n_samples].contiguous()
    built = not native._so_path("treeshap_cext").exists()
    t0 = time.time()
    native.load("treeshap_cext")
    build_s = time.time() - t0
    host = trees.Forest(*(t.cpu() for t in forest[:-1]), forest.max_depth)
    ft = baseline.forest_trees(host)
    xh = x.cpu().numpy()
    t0 = time.time()
    phi = baseline.forest_shap_class0_cext(ft, xh)
    cext_s = time.time() - t0
    treeshap.forest_shap_class0(forest, x)
    torch.cuda.synchronize()
    t0 = time.time()
    k2 = treeshap.forest_shap_class0(forest, x)
    torch.cuda.synchronize()
    k2_s = time.time() - t0
    k2 = k2.double().cpu().numpy()
    ref = float(np.abs(k2).max())
    err = float(np.abs(phi - k2).max())
    _require(err <= SHAP_TOL[0] * ref + SHAP_TOL[1],
             f"cext against K2: {err} off (max {ref})")
    return {"config": result["config"], "trees": len(ft),
            "samples": n_samples,
            "node_slots": int(forest.feature.shape[1]),
            "built": built, "build_s": build_s, "cext_s": cext_s,
            "k2_s": k2_s, "max_abs_err": err, "max_abs_k2": ref,
            "host_cpu": _cpu_model(), "wall_s": time.time() - t_check}


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
    """The Extra Trees member's explain (the widest forest) in each mode
    (``x`` its first 64 preprocessed samples, the interventional
    background their first 32) timed once unprofiled, after one warm run, and once more under the
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
        if keys[4] != "Extra Trees":
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
    from flake16_framework_tpu_torch.obs import aot
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
    # The warm's reserved growth with the allocator's free cache emptied
    # on both sides: the graphs' private pools, their static buffers and
    # the prepared models.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    compiles0 = aot.dispatch_stats()["compiles"]
    t0 = time.time()
    svc.start()
    warm_s = time.time() - t0
    warm_compiles = aot.dispatch_stats()["compiles"] - compiles0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    graphs_gb = (torch.cuda.memory_reserved() - reserved0) / 1e9
    warmed = _read_counts()
    clock = _KindClock(svc)
    torch.cuda.reset_peak_memory_stats()
    compiles0 = aot.dispatch_stats()["compiles"]
    load = sustained_load(clock, feats, registry.ids(),
                          n_requests=SERVE_REQUESTS, rows=SERVE_ROWS,
                          kinds=("predict", "shap"), clients=SERVE_CLIENTS)
    load_compiles = aot.dispatch_stats()["compiles"] - compiles0
    launches = _read_counts()
    peak_load = torch.cuda.max_memory_allocated() / 1e9
    triples = len(GRID_CONFIGS) * 2 * len(SERVE_BUCKETS)
    _require(warm_compiles == triples and load_compiles == 0,
             f"graph captures: {warm_compiles} at warm for {triples} "
             f"(model, kind, bucket) triples, {load_compiles} under load")
    captures = {kind: sorted(g.capture_s for g in c.graphs().values())
                for kind, c in svc.store._caches.items()}
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
        "warm_compiles": warm_compiles, "load_compiles": load_compiles,
        "capture_s": captures, "graphs_reserved_gb": graphs_gb,
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


def _timed_calls(fn, reps=20):
    """Median host ms of ``fn()`` and a synchronize, over ``reps``."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def check_served_graphs(svc, registry, feats, buckets=SERVE_BUCKETS):
    """The store's CUDA graphs (``obs/aot.py``) against their eager bodies
    (``traceable()``, handed out by ``audit_handles``) for every model,
    kind and bucket, on random rows: predict bitwise, SHAP within
    SHAP_TOL, a SHAP replay counting one K2 launch and a predict replay
    none, and each model's SHAP replay at the largest bucket against
    ``unit_shap_plain`` on its live serving rows (rows with u = 0 add
    exact zeros) within SHAP_TOL (the ET model's record is the serve
    phase's K2 check); no capture on the way. Two threads replay the ET model's SHAP graph at
    the middle bucket with different batches (each must get its own
    answer), and a reload of that model (a new object for its id)
    captures again at the next call. The eager body (with the batch's
    host-to-device copy, as the store ran it before graphs) and the
    replay (``store.call``) are timed at each kind and bucket on the ET
    model, in turns (eager, replay, replay, eager). Returns the
    report."""
    import threading

    from flake16_framework_tpu_torch.kernels.treeshap_unit import (
        unit_shap, unit_shap_plain,
    )
    from flake16_framework_tpu_torch.obs import aot
    from flake16_framework_tpu_torch.ops.preprocess import transform
    from flake16_framework_tpu_torch.serve import model_id_for

    store = svc.store
    rs = np.random.RandomState(7)
    rows = []
    compiles0 = aot.dispatch_stats()["compiles"]

    def batch(model, bucket):
        pick = rs.choice(len(feats), bucket, replace=False)
        return np.ascontiguousarray(feats[pick][:, list(model.cols)],
                                    dtype=np.float32)

    def eager(model, kind, x):
        fn, args, kw = store.audit_handles(model, x)[f"serve.{kind}"]
        return fn(*args, **kw)

    for model in registry.models():
        prep = store._prepare(model)
        live = prep.shap_rows[4] > 0
        live_rows = tuple(t[live] for t in prep.shap_rows)
        for bucket in buckets:
            x = batch(model, bucket)
            for kind in ("predict", "shap"):
                k2 = unit_shap.launches
                got = store.call(model, kind, x)
                torch.cuda.synchronize()
                launched = unit_shap.launches - k2
                want = eager(model, kind, x)
                rec = {"model": model.model_id, "kind": kind,
                       "bucket": bucket, "replay_k2": launched}
                _require(launched == (kind == "shap"),
                         f"{model.model_id} {kind}@{bucket}: a replay "
                         f"counted {launched} K2 launches")
                if kind == "predict":
                    _require(torch.equal(got, want),
                             f"{model.model_id} predict@{bucket}: the "
                             f"replay differs from the eager body")
                    rec["bitwise"] = True
                else:
                    ref = float(want.abs().max())
                    err = float((got - want).abs().max())
                    _require(err <= SHAP_TOL[0] * ref + SHAP_TOL[1],
                             f"{model.model_id} shap@{bucket}: the replay "
                             f"is {err} off the eager body (max {ref})")
                    rec.update(max_abs_err=err, max_abs=ref)
                    if bucket == max(buckets):
                        xp = transform(torch.from_numpy(x).cuda(), prep.mu,
                                       prep.wmat).contiguous()
                        plain = unit_shap_plain(*live_rows, xp)
                        err_plain = float((got - plain.T / prep.n_trees)
                                          .abs().max())
                        _require(err_plain <= SHAP_TOL[0] * ref
                                 + SHAP_TOL[1],
                                 f"{model.model_id} shap@{bucket}: the "
                                 f"replay is {err_plain} off "
                                 f"unit_shap_plain (max {ref})")
                        rec.update(max_abs_err_plain=err_plain,
                                   live_rows=int(live.sum()),
                                   rows=int(live.numel()),
                                   max_abs_plain=float(plain.abs().max()),
                                   k2_max_abs_err=float(
                                       (unit_shap(*prep.shap_rows, xp)
                                        - plain).abs().max()))
                rows.append(rec)
    _require(aot.dispatch_stats()["compiles"] == compiles0,
             "replays of warmed graphs captured again")

    et = registry.get(model_id_for(GRID_CONFIGS[0]))
    mid_bucket = buckets[len(buckets) // 2]
    xs = [batch(et, mid_bucket) for _ in range(2)]
    want = [eager(et, "shap", x) for x in xs]
    got, errors = {}, []

    def replays(i):
        try:
            torch.cuda.set_device(store.device)
            for _ in range(20):
                got[i] = store.call(et, "shap", xs[i])
            torch.cuda.synchronize()
        except Exception as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=replays, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _require(not errors, f"concurrent replays raised {errors}")
    concurrent = []
    for i in (0, 1):
        ref = float(want[i].abs().max())
        err = float((got[i] - want[i]).abs().max())
        other = float((got[i] - want[1 - i]).abs().max())
        _require(err <= SHAP_TOL[0] * ref + SHAP_TOL[1] and other > err,
                 f"concurrent replay {i}: {err} off its own answer, "
                 f"{other} off the other thread's")
        concurrent.append({"max_abs_err": err, "max_abs_to_other": other})

    twin = type(et)(**{k: getattr(et, k) for k in et.__slots__})
    before = store.call(et, "shap", xs[0])
    compiles0 = aot.dispatch_stats()["compiles"]
    registry.register(twin, persist=False)
    try:
        after = store.call(twin, "shap", xs[0])
        recaptured = aot.dispatch_stats()["compiles"] - compiles0
    finally:
        registry.register(et, persist=False)
    _require(recaptured == 1 and torch.equal(before, after),
             f"reload: {recaptured} captures, replay equal "
             f"{torch.equal(before, after)}")

    timings = []
    for bucket in buckets:
        x = batch(et, bucket)
        for kind in ("predict", "shap"):
            fn, args, kw = store.audit_handles(et, x)[f"serve.{kind}"]

            def run_eager():
                fn(args[0], torch.as_tensor(x, device=store.device), **kw)

            def run_replay():
                store.call(et, kind, x)

            run_eager(), run_replay()
            e1 = _timed_calls(run_eager)
            r1 = _timed_calls(run_replay)
            r2 = _timed_calls(run_replay)
            e2 = _timed_calls(run_eager)
            timings.append({"kind": kind, "bucket": bucket,
                            "eager_ms": [e1, e2], "replay_ms": [r1, r2]})
    return {"values": rows, "concurrent": concurrent,
            "reload_captures": recaptured, "eager_vs_replay": timings}


def check_windows_graph(store, model, feats, bucket=32):
    """A predict graph of ``model`` captured under
    ``F16_PREDICT_IMPL=windows`` at one bucket, under an owner of its own
    beside the gather graph the store captured at warm: the replay
    against the eager windows and gather bodies (``traceable()``),
    bitwise; each walk's eager body (with the batch's copy to the card)
    and replay timed in turns (eager, replay, replay, eager); the
    kernels a replay of each graph runs, by the profiler; the windows
    plan's windows and routing steps."""
    from flake16_framework_tpu_torch.ops import trees

    t_check = time.time()
    cache = store._caches["predict"]
    prep = store._prepare(model)
    owner = f"{model.model_id}#windows"
    rs = np.random.RandomState(11)
    pick = rs.choice(len(feats), bucket, replace=False)
    x = np.ascontiguousarray(feats[pick][:, list(model.cols)],
                             dtype=np.float32)
    body = cache.traceable()
    with _env({"F16_PREDICT_IMPL": "windows"}):
        t0 = time.time()
        cache.warm(owner, prep, x)
        capture_s = time.time() - t0
        replay = cache(owner, prep, x)
        windows = body(prep, torch.as_tensor(x, device=store.device))
    gather = body(prep, torch.as_tensor(x, device=store.device))
    gather_replay = cache(model.model_id, prep, x)
    _require(torch.equal(replay, windows) and torch.equal(replay, gather)
             and torch.equal(gather_replay, gather),
             f"{model.model_id} predict@{bucket}: the windows replay, the "
             f"eager windows and gather bodies differ")
    timings, owners = {}, {"windows": owner, "gather": model.model_id}
    for walk, owner_of in owners.items():
        with _env({"F16_PREDICT_IMPL": walk}):
            def run_eager():
                body(prep, torch.as_tensor(x, device=store.device))

            def run_replay():
                cache(owner_of, prep, x)

            e1 = _timed_calls(run_eager, reps=10)
            r1 = _timed_calls(run_replay)
            r2 = _timed_calls(run_replay)
            e2 = _timed_calls(run_eager, reps=10)
            kernels = _profiled(run_replay, host=False)
        copies = [k for k in kernels if k[1].startswith(("Memcpy", "Memset"))]
        timings[walk] = {
            "eager_ms": [e1, e2], "replay_ms": [r1, r2],
            "replay_kernels": sum(k[2] for k in kernels)
            - sum(k[2] for k in copies),
            "replay_copies": sum(k[2] for k in copies),
            "replay_device_ms": sum(k[0] for k in kernels)}
    plan = prep.walk_plans[trees.predict_window()]
    cache.drop(owner)
    return {"model": model.model_id, "bucket": bucket, "bitwise": True,
            "capture_s": capture_s, "n_windows": len(plan.steps),
            "routing_steps": sum(n for _, n in plan.steps),
            "wall_s": time.time() - t_check, **timings}


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


def serve_unit_report(registry, feats, graphs):
    """K2 on the single-bucket rows (``graph_inputs``) of the ET and RF
    models at the serving buckets' sample counts: the check at S = 128 on
    the ET rows against ``unit_shap_plain`` is ``check_served_graphs``'
    (``graphs``), and its ms at S = 8, 32 and 128 on both (``_cuda_ms``)
    against the operation bound of these inputs (``unit_ops`` over the
    live rows) and their bytes."""
    from flake16_framework_tpu_torch.kernels.treeshap_unit import (
        one_counts, unit_ops, unit_shap, unit_shap_plain,
    )
    from flake16_framework_tpu_torch.serve import model_id_for

    et = model_id_for(GRID_CONFIGS[0])
    rec = next(r for r in graphs["values"] if r["model"] == et
               and r["kind"] == "shap" and "k2_max_abs_err" in r)
    out = {"check": {"config": "/".join(GRID_CONFIGS[0]),
                     "samples": rec["bucket"], "rows": rec["rows"],
                     "max_abs_err": rec["k2_max_abs_err"],
                     "max_abs_plain": rec["max_abs_plain"]},
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


CHAIN_CONFIGS = (
    ("NOD", "Flake16", "None", "None", "Random Forest"),
    ("NOD", "Flake16", "None", "None", "Decision Tree"),
)
CHAIN_RUNS = {"baseline": 4, "shuffle": 2, "testinspect": 1}
# The collate_scale phase's dataset: 400 tests over 4 projects, 100 a
# project (11 OD and 30 NOD tests, so every class fills the 10 folds). The
# phase writes and reads one file a run and project and one outcome line
# a run and test; it took 214.8 s on the card at N_TESTS over N_PROJECTS,
# 139.7 s at 2,000 tests (130,078 files, 10.4 M lines), 50.3-108.7 s at
# 600 over 13 and 46.8-59.5 s at 400 over 8 (40,024 files), too much of
# the script's time limit. Runs per mode are never cut: the verb labels
# only complete tests, at the full N_RUNS.
COLLATE_TESTS, COLLATE_PROJECTS = 400, 4


def _collect_cases():
    """``tests/torch_collect_cases.py`` of this checkout, imported by path:
    the chain's toy subject and the collation's data generator."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_collect_cases.py")
    spec = importlib.util.spec_from_file_location("torch_collect_cases",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_collect_chain(tmp):
    """The collection stage chained into the card: the port's plugins on
    the 28-test toy git subject in pytest subprocesses (4 baseline, 2
    shuffle, 1 testinspect run, selected as the port's container command
    selects them), the port's ``write_tests`` on their artifacts, then
    ``write_scores`` on the card for an RF (K1) and a Decision Tree config
    at full width, held against the CPU's, ``write_shap`` on the card and
    ``write_figures`` on the result. The kernels' counts are set to 0 just
    before the scores (the plugins and the collation launch nothing) and
    read after the figures."""
    from flake16_framework_tpu_torch import config as tcfg
    from flake16_framework_tpu_torch.constants import (
        FLAKY, NON_FLAKY, OD_FLAKY,
    )
    from flake16_framework_tpu_torch.figures.report import write_figures
    from flake16_framework_tpu_torch.pipeline import write_scores, write_shap
    from flake16_framework_tpu_torch.runner.collate import write_tests
    from flake16_framework_tpu_torch.runner.containers import PLUGIN_SELECT
    from flake16_framework_tpu_torch.runner.subjects import Subject

    cases = _collect_cases()
    d = os.path.join(tmp, "collect_chain")
    subjects = os.path.join(d, "subjects")
    checkout = os.path.join(subjects, "proj", "proj")
    data = os.path.join(d, "data")
    os.makedirs(data)
    cases.make_chain_subject(checkout)
    tj = os.path.join(d, "tests.json")
    out = {}
    t0 = time.time()
    cases.collect(checkout, data, "proj", PLUGIN_SELECT,
                  os.path.dirname(os.path.abspath(__file__)),
                  shuffle_seeds=cases.chain_shuffle_seeds(),
                  n_baseline=CHAIN_RUNS["baseline"])
    out["plugin_runs"] = sum(CHAIN_RUNS.values())
    out["plugins_s"] = time.time() - t0
    t0 = time.time()
    tests = write_tests(data, tj, subjects, CHAIN_RUNS)
    out["write_tests_s"] = time.time() - t0
    labels = {nid.split("::")[-1]: row[1]
              for nid, row in tests["proj"].items()}
    _require(len(labels) == 28 and labels["test_zz_od"] == OD_FLAKY
             and labels["test_aa_dep"] == NON_FLAKY
             and all(labels[f"test_nod_{i:02d}"] == FLAKY for i in range(12))
             and all(labels[f"test_stable_{i:02d}"] == NON_FLAKY
                     for i in range(14)), f"chain labels {labels}")
    out["labels"] = {str(c): sum(v == c for v in labels.values())
                     for c in (NON_FLAKY, OD_FLAKY, FLAKY)}

    t0 = time.time()
    gpu, _, _, k1, _ = _run_scores(tj, os.path.join(d, "scores.pkl"),
                                   CHAIN_CONFIGS)
    out["scores_s"] = time.time() - t0
    _require(k1[0] > 0 and k1[1] == 0, f"chain hist_cumsum launches {k1}")
    cpu = write_scores(tj, os.path.join(d, "scores-cpu.pkl"), max_depth=48,
                       configs=list(CHAIN_CONFIGS), device="cpu",
                       progress_out=io.StringIO())
    for k in CHAIN_CONFIGS:
        _require(cpu[k][2:] == gpu[k][2:], f"chain {k}: card and CPU "
                 f"scores differ: {gpu[k][3]} vs {cpu[k][3]}")
        fp, fn, tp = gpu[k][3][:3]
        _require(fp + fn + tp <= 28 and tp > 0 and list(gpu[k][2]) == [
            "proj"], f"chain {k}: {gpu[k]}")
    out["configs"] = [{"config": "/".join(k), "hist_cumsum_launches": n,
                       "counts_fp_fn_tp": gpu[k][3][:3], "f1": gpu[k][3][5]}
                      for k, n in zip(CHAIN_CONFIGS, k1)]

    t0 = time.time()
    shap = write_shap(tj, os.path.join(d, "shap.pkl"))
    out["shap_s"] = time.time() - t0
    for r in shap:
        _require(r["values"].shape == (28, 16)
                 and np.isfinite(r["values"]).all(), "chain shap values")
    with open(os.path.join(d, "scores.pkl"), "wb") as fd:
        pickle.dump({k: gpu.get(k, gpu[CHAIN_CONFIGS[0]])
                     for k in tcfg.iter_config_keys()}, fd)
    fig = os.path.join(d, "figures")
    write_figures(tj, os.path.join(d, "scores.pkl"),
                  os.path.join(d, "shap.pkl"),
                  subjects=[Subject(name="proj", repo="org/proj", sha="x",
                                    package_dir=".", commands=("pytest",))],
                  star_fetch=lambda repo: {}, out_dir=fig)
    for name in ("tests.tex", "req-runs.tex", "corr.tex", "nod-top.tex",
                 "shap.tex"):
        _require(os.path.getsize(os.path.join(fig, name)) > 0, name)
    launches = _read_counts()
    out["launches"] = launches
    return launches, out


def time_native_collation(data):
    """The native collation module on the card's machine, on the phase's
    own coverage databases and static pickles under ``data``: loaded
    (raising if it cannot be), equal to the plain Python bodies on
    every numbits blob and every test's coverage features, and both timed
    in turns (plain, native, native, plain) over all of them."""
    import sqlite3

    from flake16_framework_tpu_torch import native
    from flake16_framework_tpu_torch.constants import SUBJECTS_DIR
    from flake16_framework_tpu_torch.runner import collate

    mod = native.load()
    out = {"module": os.path.basename(mod.__file__)}
    blobs, projects = [], {}
    for path, proj, mode, _, ext in collate.scan_data_dir(data):
        if mode != "testinspect" or ext == "tsv":
            continue
        project = projects.setdefault(proj, collate.ProjectData())
        if ext == "sqlite3":
            with contextlib.closing(sqlite3.connect(path)) as con:
                blobs += [b for (b,) in con.execute(
                    "SELECT numbits FROM line_bits")]
                collate.ingest_coverage_db(con, proj, project, SUBJECTS_DIR)
        else:
            with open(path, "rb") as fd:
                collate.ingest_static_pickle(fd, project)
    cases = [(rec.coverage, p.test_files, p.churn)
             for p in projects.values() for rec in p.tests.values()
             if rec.coverage]
    fns = {"decode": (collate._numbits_to_lines_py, mod.numbits_to_lines),
           "sums": (collate._coverage_features_py, mod.coverage_features)}
    args = {"decode": [(b,) for b in blobs], "sums": cases}
    for what, (plain, fast) in fns.items():
        got = [fast(*a) for a in args[what]]
        _require(got == [plain(*a) for a in args[what]],
                 f"native {what} != plain on the phase's data")
        if what == "decode":
            out["lines"] = sum(len(lines) for lines in got)
    out.update(blobs=len(blobs), tests=len(cases))
    for what, (plain, fast) in fns.items():
        walls = {"plain": [], "native": []}
        for name, fn in (("plain", plain), ("native", fast),
                         ("native", fast), ("plain", plain)):
            t0 = time.perf_counter()
            for a in args[what]:
                fn(*a)
            walls[name].append(time.perf_counter() - t0)
        out[f"{what}_s"] = walls
    return out


def run_collate_scale(tmp):
    """The ``tests`` verb at the study's run counts: the generator of
    ``tests/torch_collect_cases.py`` writes the plugins' artifacts of the
    synthetic dataset (seed 0, ``COLLATE_TESTS`` tests over
    ``COLLATE_PROJECTS`` projects) at the full run counts (2,500 baseline
    + 2,500 shuffle + 1 testinspect run a project), ``python -m
    flake16_framework_tpu_torch tests`` collates them in a
    child process, as a user runs it, and its ``tests.json`` must equal
    the generator's expected dict. The data directory is removed, then
    ``write_scores`` runs on the card for ``MAIN_CONFIGS`` on the collated
    ``tests.json``, with the kernels' counts set to 0 just before it and
    read just after."""
    import shutil

    from flake16_framework_tpu_torch.constants import N_RUNS, SUBJECTS_DIR
    from flake16_framework_tpu_torch.utils.synth import make_dataset

    cases = _collect_cases()
    d = os.path.join(tmp, "collate_scale")
    data = os.path.join(d, "data")
    out = {"n_runs": N_RUNS}
    t0 = time.time()
    expected, stats = cases.write_data_dir(
        data, make_dataset(n_tests=COLLATE_TESTS,
                           n_projects=COLLATE_PROJECTS,
                           seed=0), N_RUNS, SUBJECTS_DIR, seed=0)
    out["generate_s"] = time.time() - t0
    out.update(stats)
    with os.scandir(data) as it:
        out["bytes"] = sum(e.stat().st_size for e in it)
    out["native"] = time_native_collation(data)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    env.pop("F16_TELEMETRY", None)
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "flake16_framework_tpu_torch",
                        "tests"], cwd=d, env=env, capture_output=True,
                       text=True, timeout=900)
    out["verb_s"] = time.time() - t0
    _require(r.returncode == 0, f"tests verb exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    out["lines_per_s"] = out["outcome_lines"] / out["verb_s"]
    tj = os.path.join(d, "tests.json")
    with open(tj) as fd:
        got = json.load(fd)
    _require(got == expected, "collated tests.json != the generator's")
    out["tests"] = sum(len(v) for v in got.values())
    out["projects"] = len(got)
    shutil.rmtree(data)

    out_file = os.path.join(d, "scores.pkl")
    scores, launches, walls, k1, _ = _run_scores(tj, out_file, MAIN_CONFIGS)
    _require(all(n > 0 for n in k1), f"collate_scale K1 launches {k1}")
    with open(out_file, "rb") as fd:
        on_disk = pickle.load(fd)
    _check_schema(on_disk, MAIN_CONFIGS, COLLATE_PROJECTS)
    out["configs"] = _config_rows(scores, MAIN_CONFIGS, walls, k1)
    out["launches"] = launches
    return launches, out


def print_collection(chain, scale, smi):
    print(f"collect_chain ({smi}): {chain['plugin_runs']} plugin runs in "
          f"{chain['plugins_s']:.2f} s, write_tests "
          f"{chain['write_tests_s']:.3f} s, labels {chain['labels']}; "
          f"scores on the card {chain['scores_s']:.2f} s == CPU; shap "
          f"{chain['shap_s']:.2f} s; figures written; launches "
          f"{chain['launches']}", flush=True)
    for c in chain["configs"]:
        print(f"collect_chain {c['config']}: hist_cumsum launches "
              f"{c['hist_cumsum_launches']}, F1 {c['f1']}, (FP, FN, TP) "
              f"{c['counts_fp_fn_tp']}", flush=True)
    print(f"collate_scale ({smi}): {scale['files']} files, "
          f"{scale['outcome_lines']} outcome lines, {scale['bytes']} bytes "
          f"generated in {scale['generate_s']:.2f} s; tests verb "
          f"{scale['verb_s']:.2f} s ({scale['lines_per_s']:.0f} lines/s); "
          f"{scale['tests']} tests in {scale['projects']} projects == "
          f"expected", flush=True)
    nat = scale["native"]
    print(f"collate_scale native collation ({smi}): {nat['module']}; "
          f"== plain on {nat['blobs']} "
          f"numbits blobs ({nat['lines']} lines) and {nat['tests']} tests' "
          f"coverage features; decode plain "
          f"{nat['decode_s']['plain']} s, native "
          f"{nat['decode_s']['native']} s; feature sums plain "
          f"{nat['sums_s']['plain']} s, native {nat['sums_s']['native']} s "
          f"(turns plain, native, native, plain)", flush=True)
    for c in scale["configs"]:
        print(f"collate_scale {c['config']}: wall {c['wall_s']:.2f} s, "
              f"hist_cumsum launches {c['hist_cumsum_launches']}, F1 "
              f"{c['f1']}, (FP, FN, TP) {c['counts_fp_fn_tp']}", flush=True)


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


def _profiled(fn, host=True):
    """Run ``fn`` under the profiler (CPU, unless not ``host``, and CUDA)
    and return its device kernels (``_device_kernels``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
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


def check_windows_folds(tests_file):
    """Predict's windows walk on the card: fold 0 of the first RF scores
    config and of the first DT config, each fit from the sweep's own
    tensors and key, predicted on the fold's samples by both walks:
    ``predict_proba`` bitwise, ``predict`` equal under
    ``F16_PREDICT_IMPL=windows``. Each walk timed by CUDA events (the
    windows walk on its kept plan), with the plan's windows and routing
    steps."""
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.ops import trees
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    t_check = time.time()
    engine = SweepEngine(*tests_to_arrays(load_tests(tests_file)))
    out = []
    for config, fit_name in ((MAIN_CONFIGS[0], "fit_forest_hist"),
                             (DT_CONFIGS[0], "fit_forest")):
        args, kwargs = first_fold(engine, config, fit_name, run_fit=False)
        forest = getattr(trees, fit_name)(*args, **kwargs)
        x = args[0]
        gather = trees.predict_proba(forest, x, impl="gather")
        plans = {}
        windows = trees.predict_proba(forest, x, impl="windows", plans=plans)
        _require(torch.equal(gather, windows),
                 f"{config} fold 0: the windows walk differs from gather")
        with _env({"F16_PREDICT_IMPL": "windows"}):
            by_windows = trees.predict(forest, x)
        _require(torch.equal(by_windows, trees.predict(forest, x)),
                 f"{config} fold 0: predict differs under windows")
        plan = plans[trees.predict_window()]
        out.append({
            "config": "/".join(config), "fold": 0, "bitwise": True,
            "trees": forest.feature.shape[0], "samples": int(x.shape[0]),
            "n_nodes_max": int(forest.n_nodes.max()),
            "windows": len(plan.steps),
            "routing_steps": sum(n for _, n in plan.steps),
            "gather_ms": _cuda_ms(lambda: trees.predict_proba(
                forest, x, impl="gather"), reps=5),
            "windows_ms": _cuda_ms(lambda: trees.predict_proba(
                forest, x, impl="windows", plans=plans), reps=5),
            "wall_s": time.time() - t_check})
    return out


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
        launch_rows = {k: kern.get(k) for k in ("kernel.hist_cumsum",
                                                "kernel.treeshap_unit")}
        # and one cost row an instrumented entry point (obs/costs.py)
        cost_rows = {r["kernel"]: r["metrics"] for r in rows
                     if r["kernel"].startswith("kernel.")
                     and r["kernel"] not in launch_rows}
        _require(rows and {r["backend"] for r in rows} == {"cuda"}
                 and launch_rows == {"kernel.hist_cumsum": tel_launches[
                     "hist_cumsum"], "kernel.treeshap_unit": tel_launches[
                     "treeshap_unit"]}
                 and {"kernel.scores.fit", "kernel.shap.fused_fit",
                      "kernel.shap.unit_pallas"} <= set(cost_rows)
                 and cost_rows["kernel.scores.fit"]["flops"] > 0,
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
    cycle. ``plain`` is the drill without the witness, from this call.
    Then ``_perfdb_recovery_witness``: a second dump with an edge between
    two of the package's locks."""
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
    recovery = _perfdb_recovery_witness(tmp, root)
    return {"locks": len(dump["locks"]), "edges": len(dump["edges"]),
            "acquire_edges_total": sum(e[2] for e in dump["edges"]),
            "edge_sites": [[rel(a), rel(b), n] for a, b, n in dump["edges"]],
            "perfdb_recovery": recovery,
            "foreign_releases": dump["foreign_releases"],
            "reconcile": rec, "wall_s": rep["wall_s"],
            "ready_s": rep["ready_s"], "counts": rep["counts"],
            "plain_wall_s": plain["wall_s"],
            "plain_ready_s": plain["ready_s"]}


# The witnessed child of ``_perfdb_recovery_witness``: telemetry on, one
# row appended to a database whose tail a dying writer tore.
_RECOVERY_CHILD = """
import sys
from flake16_framework_tpu_torch import obs
from flake16_framework_tpu_torch.obs import perfdb
obs.configure(sys.argv[2])
row = perfdb.make_row("cuda", "drill", "config.drill", {"fit_s": 1.0},
                      src="lockwatch-drill", ts=1.0)
print(perfdb.append([row], path=sys.argv[1]))
obs.shutdown()
"""


def _perfdb_recovery_witness(tmp, root):
    """A child with the witness armed appends to a performance database
    with a torn tail under telemetry: ``perfdb.append`` cuts the tail
    under ``_append_lock`` and emits the truncation event, which takes
    ``obs/core``'s ``_lock``. The dump (``lockwatch-perfdb.json``) must
    hold that edge and no cycle, and the database its one row."""
    from flake16_framework_tpu_torch.obs import lockwatch, perfdb

    db = os.path.join(tmp, "lockwatch-perfdb.jsonl")
    path = os.path.join(tmp, "lockwatch-perfdb.json")
    with open(db, "w") as fd:
        fd.write('{"schema": "flake16-perfdb-v1", "backend": "cu')
    env = dict(os.environ, PYTHONPATH=root, **{lockwatch.ENV_VAR: path})
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-c", _RECOVERY_CHILD, db,
         os.path.join(tmp, "lockwatch-perfdb-telemetry")],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=120)
    wall = time.time() - t0
    _require(proc.returncode == 0 and proc.stdout.strip() == "1",
             f"perfdb recovery witness: exit {proc.returncode}, "
             f"{proc.stdout[-400:]} {proc.stderr[-1200:]}")
    with open(path) as fd:
        dump = json.load(fd)
    edges = [[os.path.relpath(a, root), os.path.relpath(b, root), n]
             for a, b, n in dump["edges"]]
    want = [os.path.join("flake16_framework_tpu_torch", "obs", m)
            for m in ("perfdb.py", "core.py")]
    rows = perfdb.load(db)
    _require(any([a.rpartition(":")[0], b.rpartition(":")[0]] == want
                 for a, b, _ in edges)
             and lockwatch.reconcile(dump, {"locks": {}, "edges": []},
                                     root=root)["cycle"] is None
             and len(rows) == 1,
             f"perfdb recovery witness: edges {edges}, rows {len(rows)}")
    return {"dump": path, "locks": len(dump["locks"]), "edge_sites": edges,
            "wall_s": wall}


TUNE_FAMILIES = ("Flake16/Random Forest", "Flake16/Extra Trees",
                 "FlakeFlagger/Random Forest")
# The family ``tune`` probes (``--family``): each candidate is a child
# process of about 12 s on the card, most of it the process's start, and
# all three families' six probes took 72.4 s of the script's time limit.
TUNE_PROBED = TUNE_FAMILIES[0]
TUNE_TREES = 100


def _tuned_scores(tmp, tj, family, width, db):
    """``scores planner`` on ``family``'s probe configs under the tuned
    database ``db``, then with none (``F16_PERFDB=0``), the launch counts
    set to 0 just before each run and read just after: scores bitwise
    equal, K1 launches other than the default width's when ``width`` is
    not the default. Returns the family's report."""
    from flake16_framework_tpu_torch.obs import perfdb
    from flake16_framework_tpu_torch.parallel import planner
    from flake16_framework_tpu_torch.perf import probe

    fs_name, model = family.split("/", 1)
    configs = [k for k in probe.CONFIGS if (k[1], k[4]) == (fs_name, model)]
    shape = planner.plan_shape(fs_name, model, n=N_TESTS, n_folds=10)
    _require(perfdb.tuned_fit_overrides("cuda", shape, model=model, path=db)
             == {"node_batch": width}, f"{family}: tuned row not consulted")
    tag = family.replace("/", "-").replace(" ", "_")
    runs = {}
    try:
        for name, where in (("tuned", db), ("untuned", "0")):
            os.environ[perfdb.DB_ENV] = where
            t0 = time.time()
            scores, launches, _, _, _ = _run_scores(
                tj, os.path.join(tmp, f"scores-tune-{tag}-{name}.pkl"),
                configs, planner=True)
            runs[name] = (scores, launches, time.time() - t0)
    finally:
        os.environ[perfdb.DB_ENV] = "0"
    (tuned, tl, tw), (plain, pl, pw) = runs["tuned"], runs["untuned"]
    for k in configs:
        _require(pickle.dumps(tuned[k][2:]) == pickle.dumps(plain[k][2:]),
                 f"{family}: {k} scores differ under the tuned row")
    _require(tl["hist_cumsum"] > 0 and (width == NODE_BATCH or tl[
        "hist_cumsum"] != pl["hist_cumsum"]),
        f"{family}: K1 {tl} at width {width} against {pl}")
    return {"family": family, "configs": ["/".join(k) for k in configs],
            "width": width, "tuned_launches": tl, "untuned_launches": pl,
            "tuned_wall_s": tw, "untuned_wall_s": pw}


def run_tune_lint(tmp, tj):
    """The autotuner and the lint on the card (the module docstring's
    ``tune_lint``). Returns (launches by sub-path, report); the probes'
    launches are those their lines report (one timed run each, in the
    probe's own process), the scores runs' are read here."""
    from flake16_framework_tpu_torch.analysis import concurrency as conc
    from flake16_framework_tpu_torch.analysis.cli import lint_main
    from flake16_framework_tpu_torch.obs import lockwatch, perfdb
    from flake16_framework_tpu_torch.perf import tuner

    db = os.path.join(tmp, "tune-perfdb.jsonl")
    argv = ["--n", str(N_TESTS), "--trees", str(TUNE_TREES), "--db", db]
    field = ["base", f"F16_HIST_NODE_BATCH={TUNED_NODE_BATCH}"]
    for extra, want in (([], field + ["F16_HIST_BINS=32",
                                      "F16_HIST_BINS=48"]),
                        (["--no-parity-knobs"], field)):
        buf = io.StringIO()
        _require(tuner.tune_main(argv + ["--dry-run", *extra], out=buf)
                 == 0, f"tune --dry-run {extra}")
        dry = json.loads(buf.getvalue())
        _require(dry["backend"] == "cuda"
                 and sorted(dry["families"]) == sorted(TUNE_FAMILIES)
                 and all(f["candidates"] == want
                         for f in dry["families"].values()),
                 f"tune --dry-run {extra}: {json.dumps(dry)[:800]}")

    # The widths alone: a bin count would add two probes and, were one to
    # win, the parity oracle's full tier in a child (parity_full runs it).
    buf = io.StringIO()
    t0 = time.time()
    code = tuner.tune_main(argv + ["--family", TUNE_PROBED, "--timeout",
                                   "300", "--no-parity-knobs"], out=buf)
    tune_s = time.time() - t0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    probes = [dict(p, family=fam) for fam, f in summary["families"].items()
              for p in f["probes"]]
    _require(code == 0 and list(summary["families"]) == [TUNE_PROBED]
             and len(probes) == 2
             and not any(tuner.probe_failed(p) for p in probes)
             and all(p["launches"]["hist_cumsum"] > 0 and p["knobs"].get(
                 "F16_HIST_NODE_BATCH") == p["candidate"].get(
                     "F16_HIST_NODE_BATCH") for p in probes),
             f"tune: exit {code}, probes {json.dumps(probes)[:1500]}")
    probe_launches = {k: sum(p["launches"][k] for p in probes)
                      for k in ("hist_cumsum", "treeshap_unit")}
    rows = perfdb.load(db) if os.path.exists(db) else []
    recorded = [fam for fam, f in summary["families"].items()
                if f["recorded_crc"]]
    _require(len(rows) == len(recorded)
             and all(r["tuned"] and r["backend"] == "cuda" for r in rows),
             f"tune rows {rows} against winners {recorded}")
    t0 = time.time()
    tuned = [_tuned_scores(tmp, tj, fam, int(summary["families"][fam][
        "env"]["F16_HIST_NODE_BATCH"]), db) for fam in recorded]
    scores_s = time.time() - t0
    scores_launches = {k: sum(t["tuned_launches"][k] + t["untuned_launches"][
        k] for t in tuned) for k in ("hist_cumsum", "treeshap_unit")}

    out = io.StringIO()
    t0 = time.time()
    code = lint_main(["--json"], out=out)
    lint_s = time.time() - t0
    rep = json.loads(out.getvalue())
    _require(code == 0 and rep["findings"] == [],
             f"lint: exit {code}, {json.dumps(rep['findings'])[:800]}")
    out = io.StringIO()
    t0 = time.time()
    conc_code = lint_main(["--concurrency", "--json"], out=out)
    root = os.path.dirname(os.path.abspath(__file__))
    model = conc.build_lock_model([os.path.join(
        root, "flake16_framework_tpu_torch")])
    conc_s = time.time() - t0
    recs = {}
    for name in ("lockwatch.json", "lockwatch-perfdb.json"):
        with open(os.path.join(tmp, name)) as fd:
            dump = json.load(fd)
        recs[name] = (dump, lockwatch.reconcile(dump, model, root=root))
    _require(conc_code == 0 and all(
        rec["ok"] and rec["cycle"] is None and not rec["violations"]
        for _, rec in recs.values())
        and recs["lockwatch-perfdb.json"][1]["checked_edges"] > 0,
        f"lint --concurrency exit {conc_code}; reconcile "
        f"{json.dumps([r for _, r in recs.values()])[:1200]}")
    return {"tune_probes": probe_launches, "tune_scores": scores_launches}, {
        "dry_run": dry["families"], "tune_s": tune_s,
        "families": {fam: {k: f[k] for k in (
            "winner", "env", "wall_s", "base_wall_s", "gain_pct", "shape",
            "recorded_crc")} for fam, f in summary["families"].items()},
        "probes": probes, "probe_launches": probe_launches,
        "tuned_scores": tuned, "tuned_scores_s": scores_s,
        "lint": {"files": rep["counts"]["files"],
                 "findings": len(rep["findings"]),
                 "suppressed_inline": rep["counts"]["suppressed_inline"],
                 "suppressed_baseline": rep["counts"]["suppressed_baseline"],
                 "rules": len(rep["rules"]), "wall_s": lint_s},
        "concurrency": {"lock_sites": len(model["locks"]),
                        "static_edges": len(model["edges"]),
                        "wall_s": conc_s, "dumps": {name: {
                            "dynamic_edges": len(dump["edges"]),
                            "dynamic_locks": len(dump["locks"]),
                            "known_locks": rec["known_locks"],
                            "checked_edges": rec["checked_edges"],
                            "unmatched_edges": rec["foreign_edges"],
                            "violations": rec["violations"],
                            "cycle": rec["cycle"]}
                            for name, (dump, rec) in recs.items()}}}


AUDIT_TIMEOUT_S = 300
# The audit's configs: the first 2 of each family (12 of the grid's 216,
# the CPU test's sub-grid; ``audit --per-family``), every plan of the
# census still run.
AUDIT_PER_FAMILY = 2
HIST_MODELS = ("Random Forest", "Extra Trees")


def _audit_child(tmp, argv):
    """``python -m flake16_framework_tpu_torch <argv>`` started in ``tmp``
    (the checkout on its path; the performance database off, as in every
    phase but ``perfdb_path``)."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    env.pop("F16_FAULT_INJECT", None)
    return subprocess.Popen(
        [sys.executable, "-m", "flake16_framework_tpu_torch", *argv],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _seeded_audit_entry(x):
    """A fixture for the recorder on the card: an op PyTorch's
    deterministic mode flags on CUDA, and a move to the host."""
    return torch.histc(x, bins=8).cpu()


def run_audit_path(tmp):
    """The audit on the card (the module docstring's ``audit_path``).
    Returns (launches of the audit's entries, report)."""
    from flake16_framework_tpu_torch.analysis import ir, rules_ir
    from flake16_framework_tpu_torch.obs.perf_diff import perf_main
    from flake16_framework_tpu_torch.perf import tuner

    adir = os.path.join(tmp, "audit")
    os.makedirs(adir)
    t0 = time.time()
    sample = ["--per-family", str(AUDIT_PER_FAMILY)]
    audit = _audit_child(adir, ["audit", "--json", *sample])
    lint = _audit_child(adir, ["lint", "--ir", "--json", *sample])
    out, err = audit.communicate(timeout=AUDIT_TIMEOUT_S)
    audit_s = time.time() - t0
    lout, lerr = lint.communicate(timeout=AUDIT_TIMEOUT_S)
    lint_s = time.time() - t0
    _require(audit.returncode == 0,
             f"audit: exit {audit.returncode}\n{out[-3000:]}\n{err[-3000:]}")
    doc = json.loads(out)
    envs = {e["entry"]: e for e in doc["envelopes"]}
    c, sc = doc["census"], doc["shap_census"]
    _require(doc["backend"] == "cuda" and doc["findings"] == []
             and c["match"] is True and sc["match"] is True
             and c["source"] == sc["source"] == "executor"
             and c["static"] == c["runtime"] == 6
             and sc["static"] == sc["runtime"] == 6
             and len(envs) == len(doc["entries"]) == 19,
             f"audit: findings {json.dumps(doc['findings'])[:1500]}, "
             f"census {c}, shap census {sc}, entries {doc['entries']}")
    for name, e in envs.items():
        model = name.rsplit("/", 1)[-1].rstrip("]")
        if name.startswith(("scores.plan_batch", "shap.plan_batch")):
            _require((e["k1_launches"] > 0) == (model in HIST_MODELS),
                     f"audit {name}: K1 {e['k1_launches']} launches")
        if name.startswith("shap.plan_batch[") or name in (
                "shap.path", "serve.shap"):
            _require(e["k2_launches"] > 0,
                     f"audit {name}: K2 {e['k2_launches']} launches")
        _require(e["peak_bytes"] <= e["allocator_peak_bytes"],
                 f"audit {name}: recorded peak {e['peak_bytes']} B above "
                 f"the allocator's {e['allocator_peak_bytes']} B")
        _require(not e["nondet"], f"audit {name}: nondeterministic ops "
                 f"{e['nondet']}")
    _require(lint.returncode == 0,
             f"lint --ir: exit {lint.returncode}\n{lout[-3000:]}\n"
             f"{lerr[-3000:]}")
    lrep = json.loads(lout)
    seeded, _ = ir.trace_entry(_seeded_audit_entry, (torch.arange(
        64.0, device="cuda"),), entry="seeded")
    rules = sorted(f.rule for f in rules_ir.program_findings(
        "seeded", seeded, path="chip_smoke.py", declared={}))
    _require(rules == ["I101", "I201"]
             and any("histc" in k for k in seeded["nondet"]),
             f"the recorder on a seeded CUDA entry: {rules}, {seeded}")

    path = os.path.join(adir, "audit.json")
    with open(path, "w") as fd:
        fd.write(out)
    db = os.path.join(adir, "perfdb.jsonl")
    ingest = io.StringIO()
    perf_main(["ingest", path, "--db", db], out=ingest)
    argv = ["--dry-run", "--n", str(N_TESTS), "--trees", str(TUNE_TREES),
            "--db", db]
    dry = {}
    for name, extra in (("default", []), ("between", None)):
        if extra is None:
            env = dry["default"]["envelope"]
            cap = env["peak_mb"] * (TUNED_NODE_BATCH + 128) / 2 \
                / env["width"]
            extra = ["--mem-cap-mb", f"{cap:.6f}"]
        buf = io.StringIO()
        _require(tuner.tune_main(argv + extra, out=buf) == 0,
                 f"tune --dry-run {extra}")
        dry[name] = json.loads(buf.getvalue())
    env = dry["default"]["envelope"]
    _require(env["width"] == 128 and env["peak_mb"] == max(
        e["peak_mb"] for e in envs.values()), f"anchor envelope {env}")
    for fam in TUNE_FAMILIES:
        d, b = dry["default"]["veto"][fam], dry["between"]["veto"][fam]
        _require(d["vetoed"] == [] and not any(
            w["vetoed"] for w in d["widths"].values()),
            f"tune --dry-run {fam} at the default cap: {d}")
        _require(b["widths"]["128"]["vetoed"]
                 and not b["widths"][str(TUNED_NODE_BATCH)]["vetoed"]
                 and b["vetoed"] == [],
                 f"tune --dry-run {fam} between the widths: {b}")
    launches = {"hist_cumsum": sum(e["k1_launches"] for e in envs.values()),
                "treeshap_unit": sum(e["k2_launches"]
                                     for e in envs.values())}
    return launches, {
        "audit_s": audit_s, "lint_ir_s": lint_s,
        "census": c, "shap_census": sc, "findings": len(doc["findings"]),
        "seeded": {"rules": rules, "nondet": seeded["nondet"],
                   "host_reads": seeded["host_reads"]},
        "envelopes": doc["envelopes"],
        "lint_ir": {"findings": len(lrep["findings"]),
                    "files": lrep["counts"]["files"]},
        "ingested": ingest.getvalue().strip(),
        "dry_run": {name: {"envelope": d["envelope"], "veto": d["veto"]}
                    for name, d in dry.items()}}


def print_audit(au, smi):
    c, sc = au["census"], au["shap_census"]
    print(f"audit ({smi}): {len(au['envelopes'])} entries recorded in "
          f"{au['audit_s']:.2f} s; census static {c['static']} runtime "
          f"{c['runtime']}, shap census static {sc['static']} runtime "
          f"{sc['runtime']} ({c['source']}); {au['findings']} findings",
          flush=True)
    for e in au["envelopes"]:
        alloc = e["allocator_peak_bytes"]
        print(f"audit {e['entry']} ({smi}): host reads "
              f"{sum(e['host_reads'].values())} at {len(e['host_reads'])} "
              f"sites, K1 {e['k1_launches']}, K2 {e['k2_launches']}, "
              f"{e['aten_ops']} aten ops, peak {e['peak_mb']:.3f} MB "
              f"(allocator {alloc / 2**20:.3f} MB, ratio "
              f"{e['peak_bytes'] / alloc:.3f}), wall {e['wall_s']:.3f} s",
              flush=True)
    print(f"audit seeded CUDA entry: {au['seeded']['rules']} "
          f"({json.dumps(au['seeded']['nondet'])}, "
          f"{json.dumps(au['seeded']['host_reads'])})", flush=True)
    print(f"lint --ir: exit 0, {au['lint_ir']['findings']} findings over "
          f"{au['lint_ir']['files']} files, {au['lint_ir_s']:.2f} s from "
          f"the audit's start; perf ingest: {au['ingested']}", flush=True)
    for name, d in au["dry_run"].items():
        fam = TUNE_FAMILIES[0]
        print(f"tune --dry-run at the {name} cap "
              f"({d['envelope']['cap_mb']:.3f} MB; anchor "
              f"{d['envelope']['peak_mb']} MB at width "
              f"{d['envelope']['width']}): {fam} widths "
              f"{json.dumps(d['veto'][fam]['widths'])}, vetoed "
              f"{d['veto'][fam]['vetoed']}", flush=True)


def print_graphs(serve, smi):
    """The serving store's graphs: captures, walls, memory, the checks
    against the eager bodies, and eager against replay by kind and
    bucket."""
    g = serve["graphs"]
    walls = [w for ws in serve["capture_s"].values() for w in ws]
    shap = [r for r in g["values"] if r["kind"] == "shap"]
    print(f"serve graphs ({smi}): {serve['warm_compiles']} captures at warm "
          f"(one a model, kind and bucket), {serve['load_compiles']} under "
          f"load; capture walls {min(walls):.4f}-{max(walls):.4f} s (sum "
          f"{sum(walls):.3f} s); warm's reserved growth (graphs' pools, "
          f"static buffers, prepared models) {serve['graphs_reserved_gb']:.3f}"
          f" GB; replays == eager bodies (predict bitwise, "
          f"SHAP max err {max(r['max_abs_err'] for r in shap):.3g}, against "
          f"unit_shap_plain "
          f"{max(r.get('max_abs_err_plain', 0) for r in shap):.3g});"
          f" K2 against it on the live rows at S = 128 "
          f"{max(r.get('k2_max_abs_err', 0) for r in shap):.3g}; one K2 "
          f"launch a SHAP replay; concurrent replays "
          f"{json.dumps(g['concurrent'])}; reload captured "
          f"{g['reload_captures']}", flush=True)
    for t in g["eager_vs_replay"]:
        print(f"serve {t['kind']}@{t['bucket']} ET ({smi}): eager "
              f"{t['eager_ms'][0]:.3f}/{t['eager_ms'][1]:.3f} ms, replay "
              f"{t['replay_ms'][0]:.3f}/{t['replay_ms'][1]:.3f} ms a call "
              f"(median of 20, eager replay replay eager)", flush=True)


def print_tune_lint(tl, smi):
    for fam, f in tl["dry_run"].items():
        print(f"tune --dry-run {fam} ({f['shape']}): field "
              f"{f['candidates']}", flush=True)
    for p in tl["probes"]:
        print(f"tune probe {p['family']} {json.dumps(p['candidate'])} "
              f"({smi}): wall {p['wall_s']:.4f} s (walls {p['walls']}), "
              f"exit {p['rc']}, K1 {p['launches']['hist_cumsum']} launches "
              f"a run", flush=True)
    for fam, f in tl["families"].items():
        print(f"tune {fam}: winner {f['winner']} {json.dumps(f['env'])}, "
              f"{f['wall_s']} s against base {f['base_wall_s']} s "
              f"({f['gain_pct']:+.2f}%), "
              + ("recorded" if f["recorded_crc"] else
                 "no candidate cleared the 2% floor, no row"), flush=True)
    print(f"tune: {tl['tune_s']:.2f} s for {len(tl['probes'])} probes, K1 "
          f"{tl['probe_launches']['hist_cumsum']} launches in their timed "
          f"runs", flush=True)
    for t in tl["tuned_scores"]:
        print(f"tune scores planner {t['family']} ({smi}): width "
              f"{t['width']} K1 {t['tuned_launches']['hist_cumsum']} "
              f"launches, {t['tuned_wall_s']:.2f} s; untuned K1 "
              f"{t['untuned_launches']['hist_cumsum']}, "
              f"{t['untuned_wall_s']:.2f} s; scores bitwise equal",
              flush=True)
    li, c = tl["lint"], tl["concurrency"]
    print(f"lint: {li['files']} files, {li['findings']} findings, "
          f"{li['suppressed_inline']} inline suppressions, "
          f"{li['suppressed_baseline']} baseline, {li['rules']} rules, "
          f"{li['wall_s']:.2f} s", flush=True)
    print(f"lint --concurrency: {c['lock_sites']} lock sites, "
          f"{c['static_edges']} static edges, {c['wall_s']:.2f} s",
          flush=True)
    for name, d in c["dumps"].items():
        print(f"reconcile {name}: {d['dynamic_locks']} locks, "
              f"{d['dynamic_edges']} dynamic edges: {d['checked_edges']} "
              f"between modeled locks, {d['unmatched_edges']} unmatched, "
              f"{len(d['violations'])} violations, cycle {d['cycle']}; "
              f"known locks {len(d['known_locks'])}", flush=True)


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
    rw = lw["perfdb_recovery"]
    print(f"lockwatch perfdb recovery ({smi}): {rw['locks']} lock sites, "
          f"edges {json.dumps(rw['edge_sites'])}, no cycle; child wall "
          f"{rw['wall_s']:.2f} s", flush=True)


def print_telemetry(tel, launches, smi):
    sums, prof = tel["span_launches"], tel["profiles"]
    print(f"telemetry path ({smi}): child {tel['child_s']:.1f} s, scores == "
          f"scores path, every event valid, backend cuda; report --json "
          f"(valid), --attrib, trace ({tel['trace_events']} spans) read the "
          f"run; span launches {json.dumps(sums)} == counted; launches "
          f"{launches}", flush=True)
    stages = {k: round(v, 3) for k, v in tel["attrib_stages"].items()}
    print(f"telemetry cost events ({smi}): report --attrib stages "
          f"{json.dumps(stages)}; " + "; ".join(
              f"{k} {c['n']}x {c['flops'] / 1e9:.3f} GFLOP "
              f"{c['bytes'] / 1e9:.3f} GB compile {c['compile_s']:.3f} s"
              for k, c in sorted(tel["attrib_kernel_costs"].items()))
          + f"; counted calls' walls (last of each span) "
          f"{json.dumps(tel['pass_s'])} s", flush=True)
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

# The model-changing arms (``ops/trees.py``, ``ops/preprocess.py``), each
# at full width through ``SweepEngine.run_config`` on a config of the
# family it applies to, under its ``F16_*`` variable.
ARM_DT = ("NOD", "Flake16", "None", "None", "Decision Tree")
ARMS = (
    ("bins32", MAIN_CONFIGS[0], {"F16_HIST_BINS": "32"}),
    ("bins48", MAIN_CONFIGS[0], {"F16_HIST_BINS": "48"}),
    ("refine_edge", MAIN_CONFIGS[0], {"F16_HIST_REFINE": "edge"}),
    ("quota_sklearn", MAIN_CONFIGS[0], {"F16_FEATURE_QUOTA": "sklearn"}),
    ("et_rank", MAIN_CONFIGS[1], {"F16_ET_DRAW": "rank"}),
    ("pca_eigh", MAIN_CONFIGS[1], {"F16_PCA_IMPL": "eigh"}),
    ("quota_sklearn", ARM_DT, {"F16_FEATURE_QUOTA": "sklearn"}),
)
# The card-against-CPU forest check of each arm: fold 0's inputs, this
# many trees, grown on the CPU at a window of 64 (results-neutral; the
# CPU's default 8 takes several times as long at N = 8000).
ARM_CPU_TREES, ARM_CPU_WINDOW = 2, "64"
# (FP, FN, TP) samples the eigh arm's totals may differ from svd's (the
# JAX package's bound, tests/test_sweep.py:373-378).
EIGH_TOTALS = 6
# K1's synthetic full windows beyond the main path's 64 bins.
SYNTH_BINS = (128, 256)
FOREST_FIELDS = ("feature", "threshold", "left", "right", "value",
                 "n_nodes")


@contextlib.contextmanager
def _env(values):
    """``values`` set in ``os.environ`` for the block, then restored."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def hold_steps(steps, what):
    """Each recorded step through K1 bitwise against its plain version
    and against a second run. Returns (ms of all steps back to back, the
    sum of their bounds)."""
    from flake16_framework_tpu_torch.kernels.hist import (
        cum_hists, cum_hists_plain,
    )

    for s in steps:
        got, again = cum_hists(*s), cum_hists(*s)
        want = cum_hists_plain(*s)
        _require(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"hist_cumsum differs from plain on a step of {what}")
        _require(all(torch.equal(a, b) for a, b in zip(got, again)),
                 f"hist_cumsum: two runs differ on a step of {what}")
        del got, again, want
    sum_ms = _cuda_ms(lambda: launch_steps(steps), reps=3, warm=1)
    bound = sum(hist_bound_ms(s[0], s[1], s[3], s[4], s[5])[0]
                for s in steps)
    return sum_ms, bound


def check_synthetic_window(n_bins):
    """K1 at a synthetic full window of ``n_bins`` bins, as wide as its
    shared memory holds (``kernels/hist.max_window``), bitwise against
    its plain version and a second run, and timed."""
    from flake16_framework_tpu_torch.kernels.hist import max_window

    args = synthetic_hist_inputs(n_bins, max_window(n_bins))
    ms, bound = hold_steps([args], f"a {n_bins}-bin full window")
    return {"bins": n_bins, "window": args[4], "ms": ms,
            "bound_ms": bound, "bound_share": bound / ms}


def card_cpu_forest(engine, keys, arm):
    """Fold 0's fit of ``keys`` under the arm in force (``arm``, its
    name), from the sweep's own tensors, at ``ARM_CPU_TREES`` trees: the
    card's forest bitwise against the CPU's."""
    from flake16_framework_tpu_torch.ops import trees

    fit = "fit_forest" if keys[4] == "Decision Tree" else "fit_forest_hist"
    args, kwargs = first_fold(engine, keys, fit, run_fit=False)
    kwargs = dict(kwargs, n_trees=min(ARM_CPU_TREES, kwargs["n_trees"]))
    card = getattr(trees, fit)(*args, **kwargs)

    def cpu(v):
        return v.cpu() if torch.is_tensor(v) else v

    t0 = time.time()
    with _env({"F16_HIST_NODE_BATCH_CPU": ARM_CPU_WINDOW}):
        host = getattr(trees, fit)(*map(cpu, args),
                                   **{k: cpu(v) for k, v in kwargs.items()})
    cpu_s = time.time() - t0
    for fld in FOREST_FIELDS:
        _require(torch.equal(getattr(card, fld).cpu(), getattr(host, fld)),
                 f"{'/'.join(keys)} fold 0 under {arm}: field {fld} "
                 f"differs between the card and the CPU")
    return {"trees": kwargs["n_trees"], "nodes": card.n_nodes.tolist(),
            "cpu_fit_s": cpu_s}


def run_model_arms(tj, ref):
    """The ``model_arms`` phase: each arm of ``ARMS`` through
    ``run_config`` at full width (F1, K1 launches, wall), its fold-0
    forest on the card bitwise against the CPU's, K1 bitwise against its
    plain version on every real BFS step of fold 0's fit at 32 and 48
    bins and on synthetic full windows at 128 and 256 bins, the Decision
    Tree's quota arm equal to its default (all features are its quota),
    and the eigh arm's totals within ``EIGH_TOTALS`` of svd's (the scores
    path's ``ref``). Returns (launches of the arms' runs, report)."""
    from flake16_framework_tpu_torch.config import FEATURE_SETS, PREP_PCA
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.ops import preprocess
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    arrays = tests_to_arrays(load_tests(tj))
    engine = SweepEngine(*arrays)
    dt_default = engine.run_config(ARM_DT)[3]
    rows, launches = [], {"hist_cumsum": 0, "treeshap_unit": 0}
    for name, keys, env in ARMS:
        with _env(env):
            _reset_counts()
            t0 = time.time()
            total = engine.run_config(keys)[3]
            wall = time.time() - t0
            got = _read_counts()
            forest = card_cpu_forest(engine, keys, name)
            steps = None
            if "F16_HIST_BINS" in env:
                recorded = record_steps(engine, keys)
                _require({s[5] for s in recorded} == {
                    int(env["F16_HIST_BINS"])}, f"{name}: step bins")
                sum_ms, bound = hold_steps(recorded, f"{name} {keys}")
                steps = {"steps": len(recorded), "sum_ms": sum_ms,
                         "bound_sum_ms": bound,
                         "bound_share": bound / sum_ms}
                del recorded
        for k in launches:
            launches[k] += got[k]
        dt = keys[4] == "Decision Tree"
        _require((got["hist_cumsum"] == 0) == dt,
                 f"{name} {keys}: {got['hist_cumsum']} K1 launches")
        default = dt_default if dt else ref[keys][3]
        row = {"arm": name, "env": env, "config": "/".join(keys),
               "f1": total[5], "default_f1": default[5],
               "counts_fp_fn_tp": total[:3],
               "default_counts_fp_fn_tp": default[:3], "wall_s": wall,
               "hist_cumsum_launches": got["hist_cumsum"],
               "card_cpu_forest": forest, "real_steps": steps}
        if dt:
            _require(total[:3] == default[:3],
                     f"{name}: the Decision Tree moved {total} {default}")
        if name == "pca_eigh":
            moved = sum(abs(a - b) for a, b in zip(total[:3], default[:3]))
            _require(moved <= EIGH_TOTALS,
                     f"pca_eigh totals {total[:3]} vs svd {default[:3]}")
            x = torch.from_numpy(
                engine.features[:, list(FEATURE_SETS[keys[1]])])
            w_card = preprocess.fit_preprocess(x.cuda(), PREP_PCA,
                                               pca_impl="eigh")[1]
            w_cpu = preprocess.fit_preprocess(x, PREP_PCA,
                                              pca_impl="eigh")[1]
            row["totals_moved"] = moved
            row["w_card_cpu_max_abs_diff"] = float(
                (w_card.cpu() - w_cpu).abs().max())
        rows.append(row)
    synth = [check_synthetic_window(b) for b in SYNTH_BINS]
    return launches, {"arms": rows, "synthetic_windows": synth,
                      "dt_default": dt_default}


def run_parity_full():
    """The ``parity_full`` phase: ``perf/parity.py``'s full tier (N =
    4000, 100 trees, 6 seeds, the three probe configs) on the card in this
    process against the committed sklearn cache, a config at a time with
    K1's launches read around each. Hard checks: the cache validated,
    every seed ran, and the RF and ET configs launched K1; the +/-0.01
    verdict is reported, not required. Returns (launches, report)."""
    from flake16_framework_tpu_torch.perf import parity

    rows, launches = {}, {"hist_cumsum": 0, "treeshap_unit": 0}
    t0 = time.time()
    for keys in parity.PROBE_CONFIGS:
        _reset_counts()
        rep = parity.run_parity(
            n_tests=parity.FULL["n_tests"], n_trees=parity.FULL["n_trees"],
            k_ours=parity.FULL["k_ours"], k_sk=parity.FULL["k_sk"],
            sklearn_cache=parity.CACHE, configs=[keys], device="cuda",
            **parity.DATA)
        got = _read_counts()
        row = rep["/".join(keys)]
        dt = keys[4] == "Decision Tree"
        _require(row["ours_k"] == (1 if dt else parity.FULL["k_ours"])
                 and len(row["ours_f1s"]) == row["ours_k"],
                 f"parity {keys}: {row['ours_k']} seeds ran")
        _require((got["hist_cumsum"] > 0) != dt,
                 f"parity {keys}: {got['hist_cumsum']} K1 launches")
        row["hist_cumsum_launches"] = got["hist_cumsum"]
        rows["/".join(keys)] = row
        for k in launches:
            launches[k] += got[k]
    record = parity.full_record(rows, "cuda")
    record["wall_s"] = time.time() - t0
    return launches, record


def print_model_arms(arms, parity_rep, smi):
    for r in arms["arms"]:
        steps = r["real_steps"]
        f = r["card_cpu_forest"]
        print(f"model arm {r['arm']} {r['config']} ({smi}): F1 {r['f1']} "
              f"(default {r['default_f1']}), (FP, FN, TP) "
              f"{r['counts_fp_fn_tp']}, wall {r['wall_s']:.2f} s, "
              f"hist_cumsum launches {r['hist_cumsum_launches']}; fold 0 "
              f"at {f['trees']} trees ({f['nodes']} nodes) card == CPU "
              f"bitwise (CPU {f['cpu_fit_s']:.2f} s)"
              + (f"; K1 on {steps['steps']} real steps bitwise == plain, "
                 f"{steps['sum_ms']:.4f} ms, bound "
                 f"{steps['bound_sum_ms']:.4f} ms "
                 f"({steps['bound_share']:.1%})" if steps else "")
              + (f"; totals moved {r['totals_moved']} (<= {EIGH_TOTALS}), "
                 f"W card vs CPU {r['w_card_cpu_max_abs_diff']:.3g}"
                 if "totals_moved" in r else ""), flush=True)
    for w in arms["synthetic_windows"]:
        print(f"hist_cumsum synthetic full window at {w['bins']} bins "
              f"(W = {w['window']}) ({smi}): bitwise == plain and "
              f"repeatable, {w['ms']:.4f} ms, bound {w['bound_ms']:.4f} ms "
              f"({w['bound_share']:.1%})", flush=True)
    for name, r in parity_rep["configs"].items():
        print(f"parity_full {name} ({smi}): ours {r['ours_mean']} +/- "
              f"{r['ours_sd']} ({r['ours_k']} seeds, {r['grower']}), "
              f"sklearn {r['sklearn_mean']} +/- {r['sklearn_sd']} "
              f"({r['sklearn_k']}), delta {r['delta']:+.4f}, SE "
              f"{r['se_delta']:.4f}, "
              f"{'within' if abs(r['delta']) <= 0.01 else 'OUTSIDE'} "
              f"+/-0.01; {r['wall_s']:.2f} s, hist_cumsum launches "
              f"{r['hist_cumsum_launches']}", flush=True)
    print(f"parity_full verdict ({smi}): ok {parity_rep['ok']} at "
          f"+/-{parity_rep['tolerance']} in {parity_rep['wall_s']:.2f} s "
          f"(a finding, not a check of this script)", flush=True)


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
    from flake16_framework_tpu_torch.serve import model_id_for
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
    # The collation's native host module (g++, CPython C API), built here
    # before any phase collates.
    from flake16_framework_tpu_torch import native

    t0 = time.time()
    native_built = not native._so_path("collate_fast").exists()
    native_mod = native.load("collate_fast")
    native_s = time.time() - t0
    print(f"native: {os.path.basename(native_mod.__file__)} "
          f"{'built and loaded' if native_built else 'loaded'} in "
          f"{native_s:.2f} s", flush=True)

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
        windows_folds = check_windows_folds(tj)
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
        for w in windows_folds:
            print(f"predict windows walk {w['config']} fold 0 ({smi}): "
                  f"bitwise == gather on {w['samples']} samples, "
                  f"{w['trees']} trees, {w['n_nodes_max']} nodes at most; "
                  f"{w['windows']} windows, {w['routing_steps']} routing "
                  f"steps; windows {w['windows_ms']:.3f} ms, gather "
                  f"{w['gather_ms']:.3f} ms; check {w['wall_s']:.2f} s "
                  f"since its start", flush=True)

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
        arm_launches, arms = run_model_arms(tj, ref)
        lap("model_arms")
        parity_launches, parity_rep = run_parity_full()
        lap("parity_full")
        print_model_arms(arms, parity_rep, smi)
        tel_launches, tel, tel_shap = run_telemetry_path(tmp, tj, ref)
        lap("telemetry_path")
        tel["walls"] = time_telemetry(tmp, tj)
        lap("telemetry_walls")
        print_telemetry(tel, tel_launches, smi)
        # The planner path under the budget pre-flight, at the card's
        # whole memory: every plan passes it.
        total_mb = torch.cuda.get_device_properties(0).total_memory / 2**20
        os.environ["F16_DEVICE_BUDGET_MB"] = f"{total_mb:.1f}"
        try:
            planner_launches, members, pjournal, pwall = run_planner_path(
                tmp, tj, ref)
        finally:
            del os.environ["F16_DEVICE_BUDGET_MB"]
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
        budget = run_budget_preflight(tmp, tj, members)
        lap("budget_preflight")
        for r in budget["members"]:
            print(f"budget_preflight {r['config']} ({smi}): envelope "
                  f"{r['law_bytes'] / 2**20:.1f} MB ({r['law_phase']}), "
                  f"measured {r['measured_bytes'] / 2**20:.1f} MB over "
                  f"{r['entry_bytes'] / 2**20:.1f} MB at entry, envelope / "
                  f"measured {r['ratio']:.4f}", flush=True)
        print(f"budget_preflight child ({smi}): F16_DEVICE_BUDGET_MB="
              f"{budget['budget_mb']:g} (planner path at {total_mb:.1f}), "
              f"exit {budget['child_rc']} with PlanOverBudget naming "
              f"{', '.join(f for f, _ in budget['child_named'])}; launches "
              f"{budget['child_launches']}; left {budget['child_left']}; "
              f"wall {budget['child_wall_s']:.2f} s", flush=True)
        batch_launches, cb = run_config_batch_path(tmp, tj)
        lap("config_batch_path")
        print_config_batch(cb, batch_launches, smi)
        mp_launches, mp = run_multiprocess_path(tmp)
        lap("multiprocess_path")
        print_multiprocess(mp, mp_launches, smi)
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
        cx = shap_cfgs[0]["cext"]
        print(f"cext baseline {cx['config']} ({smi}; host {cx['host_cpu']}):"
              f" {cx['trees']} trees x {cx['samples']} samples, "
              f"{'built' if cx['built'] else 'loaded'} in "
              f"{cx['build_s']:.2f} s, C++ {cx['cext_s']:.3f} s, K2 path "
              f"{cx['k2_s']:.4f} s; max err against K2 "
              f"{cx['max_abs_err']:.3g} (max {cx['max_abs_k2']:.3g}); "
              f"check {cx['wall_s']:.2f} s", flush=True)
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
            serve["graphs"] = check_served_graphs(svc, serve_reg,
                                                  serve_feats)
            serve["treeshap_unit"] = serve_unit_report(
                serve_reg, serve_feats, serve["graphs"])
            serve["windows_graph"] = check_windows_graph(
                svc.store, serve_reg.get(model_id_for(GRID_CONFIGS[0])),
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
        tune_launches, tl = run_tune_lint(tmp, tj)
        lap("tune_lint")
        print_tune_lint(tl, smi)
        audit_launches, au = run_audit_path(tmp)
        lap("audit_path")
        print_audit(au, smi)
        fleet_launches, fleet_rep, fleet_answers = run_fleet_path(
            tmp, serve_reg, serve_feats)
        fleet_rep["values"] = check_fleet_values(fleet_answers, serve_reg,
                                                 serve_feats)
        lap("fleet_path")
        drill = run_fleet_drill(tmp, serve_reg, serve_feats)
        lap("fleet_drill")
        chain_launches, chain = run_collect_chain(tmp)
        lap("collect_chain")
        scale_launches, scale = run_collate_scale(tmp)
        lap("collate_scale")
        print_collection(chain, scale, smi)
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
        print_graphs(serve, smi)
        wg = serve["windows_graph"]
        print(f"serve predict graph under windows {wg['model']}@"
              f"{wg['bucket']} ({smi}): replay == eager windows == eager "
              f"gather bitwise; captured in {wg['capture_s']:.3f} s; "
              f"{wg['n_windows']} windows, {wg['routing_steps']} routing "
              f"steps; check {wg['wall_s']:.2f} s; " + "; ".join(
                  f"{walk} eager {wg[walk]['eager_ms'][0]:.3f}/"
                  f"{wg[walk]['eager_ms'][1]:.3f} ms, replay "
                  f"{wg[walk]['replay_ms'][0]:.3f}/"
                  f"{wg[walk]['replay_ms'][1]:.3f} ms, a replay runs "
                  f"{wg[walk]['replay_kernels']} kernels and "
                  f"{wg[walk]['replay_copies']} copies "
                  f"({wg[walk]['replay_device_ms']:.3f} ms on the device)"
                  for walk in ("windows", "gather")), flush=True)
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
        for k in PROFILED_CONFIGS:
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

    paths = {"scores": score_launches, "model_arms": arm_launches,
             "parity_full": parity_launches, "telemetry": tel_launches,
             "planner": planner_launches,
             "config_batch": batch_launches,
             "multiprocess": mp_launches,
             "lopo": lopo_launches,
             "shap": shap_launches, "shap_grid": grid_launches,
             "serve": serve_launches, "fleet": fleet_launches,
             "kill_drill_resumed_child": kill["resumed_child_launches"],
             "metrics": metrics_launches, **perfdb_launches,
             **tune_launches, "audit_path": audit_launches,
             "collect_chain": chain_launches, "collate_scale": scale_launches}
    k1["launches"] = sum(p["hist_cumsum"] for p in paths.values())
    # the bin counts K1 was held at against its plain version in this run
    k1["bins_held"] = sorted({N_BINS, *SYNTH_BINS, *(
        int(a["env"]["F16_HIST_BINS"]) for a in arms["arms"]
        if "F16_HIST_BINS" in a["env"])})
    k2["launches"] = sum(p["treeshap_unit"] for p in paths.values())
    kernels = {"kernels": [{k: kern[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for kern in (k1, k2)]}
    kernels["kernels"][0]["bins_held"] = k1["bins_held"]
    report = {"nvidia_smi": smi, "build_s": build_s, "nvcc": logs,
              "native": {"built": native_built, "s": native_s},
              "kernels": [k1, k2], "launches_by_path": paths,
              "hist_real_steps": real,
              "small_reference": small, "exact_fold": exact,
              "windows_folds": windows_folds,
              "scores_path": configs, "scores_path_journal": journal,
              "model_arms": arms, "parity_full": parity_rep,
              "telemetry_path": tel,
              "planner_path": members, "planner_path_wall_s": pwall,
              "planner_path_journal": pjournal,
              "budget_preflight": budget,
              "config_batch_path": cb, "multiprocess_path": mp,
              "hist_batched_steps": batched, "planner_profile": member_prof,
              "kill_drill": kill, "sticky_fault_drill": sticky,
              "oom_drill": oom, "lopo_path": lopo_cfgs,
              "lopo_path_wall_s": lopo_wall, "shap_path": shap_cfgs,
              "shap_path_wall_s": shap_wall, "shap_grid_path": grid_rows,
              "shap_grid_modes": grid_modes, "treeshap_unit_s64": k2_grid,
              "shap_grid_explain_profiles": explains, "serve_path": serve,
              "fleet_path": fleet_rep, "fleet_drill": drill,
              "metrics_path": met, "perfdb_path": pdb,
              "lockwatch_drill": lw, "tune_lint": tl, "audit_path": au,
              "collect_chain": chain,
              "collate_scale": scale,
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
