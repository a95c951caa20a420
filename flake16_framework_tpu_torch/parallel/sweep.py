"""The per-config CV pipeline: preprocess -> bin edges (once per config,
histogram grower only) -> per fold: resample -> fit -> predict ->
per-project confusion. The folds are stratified (10) or leave one project
out (one a project).

Keys follow the JAX package exactly: the config key is
``fold_in(PRNGKey(engine.seed), config_index)`` over the canonical grid
order (``seed`` defaults to ``SEED``; the parity oracle varies it);
fold keys are ``split(config_key, n_folds)``; each fold key splits into the
resampler's key and the forest's key. An ensemble grows on the histogram
grower and the single Decision Tree on the exact grower
(``trees.hist_tier_default``; ``grower="exact"`` or
``F16_ENSEMBLE_GROWER=exact`` puts ensembles on the exact grower too).
The JAX package's model-changing arms are read when a config is
prepared or fit: ``F16_HIST_BINS`` sets the bin edges (and, through
them, K1's bins, the stage flops and the budget envelope),
``F16_HIST_REFINE``, ``F16_ET_DRAW`` and ``F16_FEATURE_QUOTA`` the
growers' arms, ``F16_PCA_IMPL`` the PCA factorization
(``ops/trees.py``, ``ops/preprocess.py``).

Three ways to run a config, each giving the same counts:

- the default path (``run_config``): folds one after another, each fit,
  predicted, counted (one host read) and journaled before the next;
- the fused config (``fused=True``) and the plan executor
  (``planner_mode=True``, ``run_plan``): the config's folds are resampled
  one after another, then their trees grow as one tree batch (10 x 100
  trees, or 10 single trees on the exact grower), so one BFS step or one
  level serves every fold and the config pays for its longest fold's
  steps, not their sum; the forests are predicted as one batch and the
  per-fold counts read with one host read. ``dispatch_trees`` and
  ``dispatch_folds`` bound a batch, and ``TREES_IN_FLIGHT`` bounds it
  when they do not; no bound changes a result. A plan's members (the
  configs of one family, ``parallel/planner.py``) run one after another,
  so each keeps its own step count. The plan executor consults the
  performance database (``obs/perfdb.py``): a recorded plan padding, and
  a tuned window width for a hist family; neither changes a result.

The config-batched sweep (the JAX package's mesh path) takes the engine's
device list (``devices=``; ``device.resolve_devices``): ``run_grid(...,
batch_size=B)`` groups configs by family into batches of B, default the
card count, and ``run_config_batch`` pads a batch to a multiple of the
card count with its first config, splits it into contiguous shards, one a
card, and on each card grows the shard's configs x folds as one tree batch
on the growers' group axis, so one BFS step or one level serves every
config of the shard. On one card a width above 1 still batches configs
onto it. Plans under ``planner_mode`` are padded to the card count and
each card runs its shard's members one after another. Each card is driven
by a worker thread of its own under ``torch.cuda.device``; the calling
thread keeps the guard, the journal and the results, and journals in
canonical member order. No batching changes a result.

A config batch can also span processes (the JAX package's multi-host
mesh): an engine given a ``group`` (``parallel/distributed.py``) pads
the batch to a multiple of the ranks' cards, takes its rank's contiguous
shard (process-major, as the JAX tool places config rows), splits it over
its own cards, and all-gathers the host counts, so every rank returns the
whole batch's results. ``run_grid`` stays single-process.

With a write-ahead journal (``resilience/journal.py``) attached, a config
resumes at fold granularity: the folds already journaled with matching
keys are taken as they are, only the missing folds are fit. ``run_grid``
runs every config, and every plan member, under the dispatch guard
(``resilience/guard.py``) as a call of its own and quarantines a config
that exhausts its attempts.

With ``F16_DEVICE_BUDGET_MB`` set, ``run_grid`` under ``planner_mode``
holds every plan's memory envelope (``parallel/envelope.py``) against
the budget before the first plan dispatches, and refuses the whole grid
with ``PlanOverBudget`` when any plan exceeds it, as the JAX package's
pre-flight does.

The entry points (``_family_fns``: a fold's fit and score, the fused
config, a plan's members, a card's shard of a config batch) are
instrumented under the JAX package's names (``obs/costs.py``): their
dispatches are counted, and with telemetry on each signature's first call
emits a ``cost`` event, the fits with the grower's stage flops.

With telemetry on (``obs``), the sweep emits the JAX package's spans and
counters: ``scores.fit`` and ``scores.score`` (one of each a fold here,
with ``fold=``; one a config there), ``scores.config`` (fused),
``scores.plan``, the ``configs``/``folds``/``trees`` counters and the
quarantine ``fault`` event, and for config batches ``scores.fit_batch``
and ``scores.score_batch`` (staged) or ``scores.config_batch`` (fused).
The fit spans carry ``k1_launches`` and ``k2_launches``. Each span closes
after a host read the path makes anyway (the fold's synchronize, the
counts' copy, the guard's synchronize), so telemetry adds none.
"""

import contextlib
import os
import queue
import threading
import time

import numpy as np
import torch

from flake16_framework_tpu_torch import config as cfg, obs, rng
from flake16_framework_tpu_torch.device import resolve, resolve_devices
from flake16_framework_tpu_torch.kernels.build import launch_counts
from flake16_framework_tpu_torch.obs import costs, perfdb
from flake16_framework_tpu_torch.ops import trees
from flake16_framework_tpu_torch.ops.metrics import (
    confusion_by_fold, confusion_by_project, format_scores,
)
from flake16_framework_tpu_torch.ops.preprocess import fit_preprocess, transform
from flake16_framework_tpu_torch.ops.resample import resample
from flake16_framework_tpu_torch.parallel import envelope, planner
from flake16_framework_tpu_torch.parallel.folds import (
    fold_masks, lopo_fold_masks,
)
from flake16_framework_tpu_torch.resilience import guard as rguard
from flake16_framework_tpu_torch.resilience import inject as rinject

N_FOLDS = 10
SEED = 0  # the config keys' default root seed, as the reference's

# Trees grown as one batch by the fused config and the plan executor when
# no dispatch bound is given (the JAX package's ``_auto_tree_chunk``).
# Bytes a tree in flight at N = 8000, F = 16, W = 128, B = 64, node
# capacity 16,000: on the histogram grower 1 MiB of K1 output, about
# 4 MiB of split-scan temporaries, 1-2 MiB of node draws and, while they
# are drawn, about 10 MiB of threefry transients; on the exact grower
# about 40 [F, N] temporaries of 0.5-1 MiB a level. So at most about
# 15 GB for 1,000 histogram trees (a 10-fold RF or ET config in one
# batch; LOPO's 26 folds in three): 11.7 GB (RF) and 12.7 GB (ET) peak
# allocated on an H100 (``chip_smoke.py``); about 8 GB for 200 exact ones.
TREES_IN_FLIGHT = {"hist": 1000, "exact": 200}

# The stage walls ``run_config(timings=)`` fills, under the JAX package's
# names (its chunk and concat stages have no counterpart here).
_STAGE_WALLS = ("tree_keys_s", "prep_s", "fit_total_s", "score_s",
                "counts_to_host_s")


def _fit_cost_fields(spec, *, n, n_feat, cap, n_folds, grower,
                     device_type):
    """The ``cost_fields`` hook of the fit-carrying entry points (the
    JAX package's): stamps the grower's analytic stage flops
    (``trees.fit_stage_flops``) for the config's fit, every fold, on the
    entry's ``cost`` event, which lets ``report --attrib`` divide the
    measured fit wall into bin / hist_build / split_scan / partition
    sub-stages. None for the exact grower (no sub-stage model), which
    includes the single Decision Tree. The port has no chunked fit
    dispatch, so a fit grows ``spec.n_trees`` trees a fold."""
    g = grower or os.environ.get("F16_ENSEMBLE_GROWER", "hist")
    if spec.n_trees <= 1 or g != "hist":
        return None
    cap_r = 2 * n if cap is None else cap
    max_nodes = 2 * cap_r

    def fields(args, kwargs):
        return {"stage_flops": trees.fit_stage_flops(
            n=cap_r, n_feat=n_feat, n_bins=trees.hist_bins(),
            n_trees=spec.n_trees * n_folds, n_nodes=max_nodes,
            max_nodes=max_nodes, device_type=device_type)}

    return fields


def _plan_key(args, kwargs):
    """A plan's dispatch key: its padded batch and the generic key of the
    rest (one family's plans of one width share a signature, as the JAX
    package's plan program does)."""
    return (args[0].batch, costs.signature(args[1:], kwargs))


def _shard_key(args, kwargs):
    """A card's shard's dispatch key: its width and the card's type."""
    return (len(args[0]), args[1].device.type)


def batch_bounds(n_trees, use_hist, dispatch_trees=None,
                 dispatch_folds=None, n_configs=1, n_folds=N_FOLDS):
    """(trees, groups) a tree batch of the fold-batched fit holds at most:
    the dispatch bounds where given, else as many as ``TREES_IN_FLIGHT``
    allows. For a batch of ``n_configs`` > 1 configs on one card, whose
    groups are configs x ``n_folds`` folds, the trees in flight over all
    of them are bounded: two RF configs grow in batches of 50 trees
    (2 x 10 x 50 = 1,000), and ``dispatch_folds`` bounds each config's
    folds. ``dispatch_folds`` is the JAX package's keyword; no entry point
    of the port sets it (the CLI's ``dispatch=N`` is ``dispatch_trees``)."""
    budget = TREES_IN_FLIGHT["hist" if use_hist else "exact"]
    if dispatch_trees:
        tree_chunk = dispatch_trees
    elif n_configs > 1:
        tree_chunk = min(n_trees, max(1, budget // (n_configs * n_folds)))
    else:
        tree_chunk = min(n_trees, budget)
    if dispatch_folds:
        return tree_chunk, dispatch_folds * n_configs
    return tree_chunk, max(1, budget // tree_chunk)


class PlanOverBudget(ValueError):
    """A family plan's peak-memory envelope exceeds the configured device
    budget (``F16_DEVICE_BUDGET_MB``): raised by the pre-flight before any
    plan dispatches, so an over-budget grid refuses on the host instead
    of running out of memory hours into the sweep."""


def plan_envelope(plan, grow_kw=None, *, n_projects, max_depth, grower,
                  device_type, dispatch_trees=None, dispatch_folds=None,
                  detail=False):
    """``envelope.plan_envelope`` of ``plan`` as ``SweepEngine.run_plan``
    runs it: on the histogram grower at the bins ``trees.hist_bins``
    resolves and the window width ``grow_kw`` names (``run_plan``'s tuned
    width), else ``trees.default_node_batch`` of ``device_type``, in the
    tree batches of ``batch_bounds``."""
    n_trees = plan.shape[2]
    hist = trees.hist_tier_default(n_trees, grower)
    n_bins = trees.hist_bins()
    width = ((grow_kw or {}).get("node_batch")
             or trees.default_node_batch(device_type, n_bins=n_bins)) \
        if hist else None
    tree_chunk, fold_chunk = batch_bounds(n_trees, hist, dispatch_trees,
                                          dispatch_folds)
    return envelope.plan_envelope(
        plan, n_projects=n_projects, max_depth=max_depth, hist=hist,
        width=width, tree_chunk=tree_chunk, fold_chunk=fold_chunk,
        device_type=device_type, detail=detail, n_bins=n_bins)


def _preflight_plan_budget(plans, *, n_projects, max_depth, grower,
                           device_type="cuda", grow_kws=None,
                           dispatch_trees=None, dispatch_folds=None):
    """The sweep's budget pre-flight: when ``F16_DEVICE_BUDGET_MB`` is
    set, bound every plan's peak device memory (``plan_envelope``, each
    plan at its ``grow_kws`` entry) and refuse the whole sweep with
    ``PlanOverBudget`` if any exceeds the budget, naming each such plan
    in ``plans``' order. Unset, empty or at most 0, it computes nothing.
    The budget is a card's: across a device list each card runs its
    shard's members one after another, so one member is in flight on a
    card and a card's envelope is its member's."""
    raw = os.environ.get("F16_DEVICE_BUDGET_MB", "")
    if not raw:
        return
    budget_mb = float(raw)
    if budget_mb <= 0:
        return
    over = []
    for pl, kw in zip(plans, grow_kws or [None] * len(plans)):
        env = plan_envelope(pl, kw, n_projects=n_projects,
                            max_depth=max_depth, grower=grower,
                            device_type=device_type,
                            dispatch_trees=dispatch_trees,
                            dispatch_folds=dispatch_folds)
        peak_mb = env["peak_bytes"] / 2**20
        if peak_mb > budget_mb:
            over.append(f"{'/'.join(pl.family)} (batch={pl.batch}): "
                        f"peak {peak_mb:.1f} MB")
    if over:
        raise PlanOverBudget(
            f"plan pre-flight: {len(over)} of {len(plans)} family "
            f"program(s) exceed the F16_DEVICE_BUDGET_MB={budget_mb:g} "
            f"device budget: " + "; ".join(over))


def _key_bytes(fold_keys):
    """Each fold key's journal bytes, as the JAX package writes them: the
    key's two uint32 words, little-endian."""
    return [k.tobytes() for k in fold_keys.cpu().numpy().astype("<u4")]


def _device_scope(device):
    """``device`` as the calling thread's current CUDA device (so the
    kernels' ``cudaSetDevice`` agrees with it); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _drain(job, thunks, results):
    """Run ``thunks`` in turn, putting (job, i, result, None) on
    ``results`` after each, (job, None, None, error) on a failure, and
    (job, -1, None, None) when the job has ended."""
    try:
        for i, thunk in enumerate(thunks):
            results.put((job, i, thunk(), None))
    # The failure crosses to the calling thread, which raises it inside
    # the guard's call.
    except Exception as e:
        results.put((job, None, None, e))
    results.put((job, -1, None, None))


def _on_cards(jobs, on_result=None):
    """Run each job, (card, [thunk, ...]), its thunks one after another on
    its card: inline when there is one job, else in a worker thread a job,
    each under its card's device. ``on_result(job, i, result)`` runs in
    the calling thread as each thunk returns (the journal's writes, in
    the caller's order). Returns [[result, ...] a job]. A failure is
    raised after every worker has ended, so no card is still working when
    the guard retries or salvages."""
    results = [[] for _ in jobs]

    def land(job, i, res):
        results[job].append(res)
        if on_result is not None:
            on_result(job, i, res)

    if len(jobs) == 1:
        card, thunks = jobs[0]
        for i, thunk in enumerate(thunks):
            land(0, i, thunk())
        return results
    landed = queue.Queue()

    def work(job, card, thunks):
        with _device_scope(card.device):
            _drain(job, thunks, landed)

    workers = [threading.Thread(target=work, args=(j, card, thunks),
                                name=f"f16-card-{j}", daemon=True)
               for j, (card, thunks) in enumerate(jobs)]
    for t in workers:
        t.start()
    errors = []
    try:
        live = len(workers)
        while live:
            job, i, res, err = landed.get()
            if i == -1:
                live -= 1
            elif err is not None:
                errors.append(err)
            elif not errors:
                land(job, i, res)
    finally:
        for t in workers:
            t.join()
    if errors:
        raise errors[0]
    return results


class _Card:
    """What the sweep keeps on one card: its device, and its copies of the
    features, the labels, the project ids and the fold masks."""

    def __init__(self, device, features, labels, project_ids, masks):
        self.device = device
        self.features = torch.as_tensor(features, device=device)
        self.labels_raw = torch.as_tensor(labels, device=device)
        self.project_ids = torch.as_tensor(project_ids, device=device)
        self.masks = {
            fl_name: tuple(torch.as_tensor(m, device=device) for m in mm)
            for fl_name, mm in masks.items()}


class SweepEngine:
    """Runs the grid from the host over a device list: ``run_config`` returns
    the reference ``scores.pkl`` value ``[t_train, t_test, scores,
    scores_total]``; ``run_grid`` runs many configs, batching configs of a
    family across the cards (``run_config_batch``) when its width is above
    1. ``device`` is one device (default ``cuda``); ``devices``, a list
    (``device.resolve_devices``), makes the engine keep a copy of the
    data on each card and split batches and plans over them. The
    per-config paths run on the first card. ``cv="lopo"`` runs
    leave-one-project-out CV, one fold a project. ``journal`` (a
    ``SweepJournal``, or None) makes configs fold-granular; configs that
    ``run_grid`` quarantined are in ``quarantined`` ({keys:
    {"fault_class", "attempts"}}), and the faults it recovered from, and
    the batches or plans it salvaged config by config, in ``retries``.

    ``fused=True`` runs each config (or batch) through the fold-batched
    fit, with the combined wall in T_TRAIN (T_TEST = 0.0);
    ``planner_mode=True`` makes ``run_grid`` run plans (``run_plan``).
    Configs with combined clocks are listed in ``fused_configs``, those
    with batch- or plan-amortized clocks in ``amortized_configs``
    (``pipeline`` writes both beside the pickle).
    ``dispatch_trees``/``dispatch_folds`` bound the trees and folds a
    batch grows; ``grower`` is the ensembles' grower
    (``trees.ensemble_grower``). ``preflight=False`` skips the budget
    pre-flight: the audit's recorded run (``analysis/ir.py``) measures
    every plan and holds the budget against what it measured. ``group``
    (a ``distributed.ProcessGroup``) makes ``run_config_batch`` split its
    batch over every rank's cards; the engine's devices are this rank's
    (``device.rank_devices``). ``seed`` is the root of every config key;
    ``engine.seed`` may be set between runs, as the parity oracle does
    (``perf/parity.py``)."""

    def __init__(self, features, labels_raw, projects, project_names,
                 project_ids, *, max_depth=48, tree_overrides=None,
                 cv="stratified", device=None, devices=None, fused=False,
                 planner_mode=False, dispatch_trees=None,
                 dispatch_folds=None, grower=None, preflight=True,
                 group=None, seed=SEED):
        if devices is not None:
            if device is not None:
                raise ValueError("pass device or devices, not both")
            self.devices = resolve_devices(devices)
            self.device = self.devices[0]
        else:
            self.device = resolve(device)
            self.devices = [self.device]
        self.preflight = preflight
        self.group = group
        self.seed = seed
        trees.ensemble_grower(grower)               # a bad value raises now
        self.grower = grower
        self.fused = fused
        self.planner_mode = planner_mode
        self.dispatch_trees = dispatch_trees
        self.dispatch_folds = dispatch_folds
        self.features = np.asarray(features, dtype=np.float32)
        self.labels_host = np.asarray(labels_raw, np.int32)
        self.projects = projects
        self.project_names = project_names
        self.max_depth = max_depth
        self.tree_overrides = tree_overrides or {}
        labels = np.asarray(labels_raw)
        if cv == "stratified":
            self.n_folds = N_FOLDS
            masks = {fl_name: fold_masks(labels == fl, self.n_folds, 0)
                     for fl_name, fl in cfg.FLAKY_TYPES.items()}
        elif cv == "lopo":
            self.n_folds = len(project_names)
            lopo = lopo_fold_masks(project_ids, self.n_folds)
            masks = {fl_name: lopo for fl_name in cfg.FLAKY_TYPES}
        else:
            raise ValueError(f"unknown cv scheme {cv!r}")
        pids = np.asarray(project_ids, np.int32)
        self._cards = [_Card(dev, self.features, self.labels_host, pids,
                             masks) for dev in self.devices]
        # The first card's copies serve the per-config paths.
        self.labels_raw = self._cards[0].labels_raw
        self.project_ids = self._cards[0].project_ids
        self._masks = self._cards[0].masks
        self._index = planner.canonical_indices()
        self.journal = None
        self.quarantined = {}
        self.retries = []
        self.fused_configs = set()
        self.amortized_configs = set()
        self._fns = {}  # family -> instrumented entry points

    def _spec(self, model_name):
        spec = cfg.MODELS[model_name]
        if model_name in self.tree_overrides:
            spec = type(spec)(spec.name, self.tree_overrides[model_name],
                              spec.bootstrap, spec.random_splits,
                              spec.sqrt_features)
        return spec

    def _prepare(self, config_keys, card=None):
        """What every fold of a config shares, on ``card`` (default the
        first): the preprocessed matrix, the labels, the bin edges
        (histogram grower: once per config, from the full preprocessed
        matrix) and the fit's keywords."""
        card = card or self._cards[0]
        fl_label, cols, prep_code, bal_code, _ = cfg.resolve_config(
            config_keys)
        spec = self._spec(config_keys[4])
        use_hist = trees.hist_tier_default(spec.n_trees, self.grower)
        with obs.region("sweep.prep"):
            x = card.features[:, list(cols)]
            cap = 2 * x.shape[0]  # SMOTE at worst doubles the training set
            y = card.labels_raw == fl_label
            mu, wmat = fit_preprocess(x, prep_code)
            xp = transform(x, mu, wmat)
            edges = trees.quantile_edges(xp) if use_hist else None
        fit_kw = dict(n_trees=spec.n_trees, bootstrap=spec.bootstrap,
                      random_splits=spec.random_splits,
                      sqrt_features=spec.sqrt_features,
                      max_depth=self.max_depth, max_nodes=2 * cap)
        return dict(y=y, xp=xp, edges=edges, use_hist=use_hist, cap=cap,
                    bal_code=bal_code, fit_kw=fit_kw)

    def _fold_keys(self, config_keys, device=None):
        """The config's fold keys [n_folds, 2]: ``split(fold_in(
        PRNGKey(self.seed), config index), n_folds)``."""
        key = rng.fold_in(rng.prng_key(self.seed, device or self.device),
                          self._index[tuple(config_keys)])
        return rng.split(key, self.n_folds)

    def _result(self, counts, t_train, t_test):
        scores, scores_total = format_scores(counts, self.project_names,
                                             self.projects)
        return [t_train, t_test, scores, scores_total]

    def run_config(self, config_keys, timings=None):
        """One config's CV; returns [t_train, t_test, scores,
        scores_total] (per-fold mean walls). With ``fused``, the config
        runs through the fold-batched fit and only its config record is
        journaled, as in the JAX package's fused path.

        ``timings``, a dict, is filled with the walls of the stages the
        port has, under the JAX package's names, summed over the folds:
        ``tree_keys_s`` (the fold keys), ``prep_s`` (the preprocessing the
        folds share), ``fit_total_s`` (resample and fit, ``prep_s``
        included), ``score_s`` (predict and counts on the device) and
        ``counts_to_host_s``. The device is synchronised after each stage
        in this timed mode only, and a fused engine runs the staged path
        instead, so the split stays measurable. Scores are the same bits
        either way."""
        config_keys = tuple(config_keys)
        name = "/".join(config_keys)
        family = (config_keys[1], config_keys[4])
        n_trees = self._spec(config_keys[4]).n_trees
        if timings is not None:
            timings.update(dict.fromkeys(_STAGE_WALLS, 0.0))
        if self.fused and timings is None:
            with obs.span("scores.config", key=(*family, "fused"),
                          counts=launch_counts, mode="fused", stage="fused",
                          config=name):
                t0 = time.time()
                counts = self._family_fns(config_keys)["config"](
                    config_keys)
                wall = time.time() - t0
            result = self._result(counts.sum(0, dtype=np.int32),
                                  wall / self.n_folds, 0.0)
            self.fused_configs.add(config_keys)
            self._count_done(1, n_trees)
            if self.journal is not None:
                self.journal.record_config(config_keys, result)
            return result

        cfg_index = self._index[config_keys]
        train_mask, test_mask = self._masks[config_keys[0]]
        t_train = t_test = 0.0
        t0 = time.time()
        fold_keys = self._fold_keys(config_keys)
        self._stage_wall(timings, "tree_keys_s", t0)
        tree_chunk = self.dispatch_trees
        # Journal resume state: folds already journaled for this config
        # with matching key bytes are trusted and not refit.
        journal = self.journal
        counts_by_fold = {}
        if journal is not None:
            key_bytes = _key_bytes(fold_keys)
            for f, (kb, cnt) in journal.partial_folds(config_keys).items():
                if 0 <= int(f) < self.n_folds and \
                        bytes(kb) == key_bytes[int(f)]:
                    counts_by_fold[int(f)] = np.asarray(cnt)
        # Each missing fold is fit, predicted and counted (one host read),
        # then journaled, so a kill loses at most the fold in flight. The
        # first missing fold's fit also prepares what the folds share.
        p = None
        fns = self._family_fns(config_keys)
        for f in range(self.n_folds):
            if f in counts_by_fold:
                continue
            with obs.span("scores.fit", key=(*family, "staged"),
                          counts=launch_counts, stage="fit", config=name,
                          fold=f):
                t0 = time.time()
                if p is None:
                    p = self._prepare(config_keys)
                    self._stage_wall(timings, "prep_s", t0)
                forest = fns["fit"](p, fold_keys[f], train_mask[f],
                                    tree_chunk)
                if self.device.type == "cuda":
                    # The fold's train clock stops after its fit.
                    torch.cuda.synchronize(  # f16lint: disable=J402
                        self.device)
                t1 = time.time()
            with obs.span("scores.score", key=(*family, "staged"),
                          stage="predict", config=name, fold=f):
                counts_by_fold[f] = fns["score"](
                    p, forest, test_mask[f:f + 1],
                    **({} if timings is None else {"timings": timings}))
                t_train += t1 - t0
                t_test += time.time() - t1
            if journal is not None:
                journal.record_fold(config_keys, f, key_bytes[f],
                                    counts_by_fold[f], config_index=cfg_index)
        counts = np.sum([counts_by_fold[f] for f in range(self.n_folds)],
                        axis=0, dtype=np.int32)
        result = self._result(counts, t_train / self.n_folds,
                              t_test / self.n_folds)
        if timings is not None:
            timings["fit_total_s"] = t_train
            for k in _STAGE_WALLS:
                timings[k] = round(timings[k], 4)
        self._count_done(1, n_trees)
        if journal is not None:
            journal.record_config(config_keys, result)
        return result

    def _family_fns(self, config_keys):
        """The family's instrumented entry points (``obs/costs.py``), made
        once a family as the JAX package's ``make_cv_fns``, under its
        span names: ``scores.fit`` (one fold's resample and fit),
        ``scores.score`` (one fold's predict and counts), ``scores.config``
        (the fused config), ``scores.plan_batch`` (a plan's members), and
        a card's shard of a config batch: ``scores.fit_batch``,
        ``scores.score_batch`` (staged) and ``scores.config_batch``
        (fused). The fit-carrying ones stamp the grower's stage flops on
        their ``cost`` events (``_fit_cost_fields``)."""
        family = (config_keys[1], config_keys[4])
        fns = self._fns.get(family)
        if fns is None:
            def fit_count_groups(configs, card):
                return self._count_groups(configs, card,
                                          *self._fit_groups(configs, card))

            fields = _fit_cost_fields(
                self._spec(family[1]), n=self.features.shape[0],
                n_feat=len(cfg.FEATURE_SETS[family[0]]), cap=None,
                n_folds=self.n_folds, grower=self.grower,
                device_type=self.device.type)
            fns = self._fns[family] = {
                "fit": costs.instrument(self._fit_fold, "scores.fit",
                                        cost_fields=fields),
                "score": costs.instrument(self._score_fold,
                                          "scores.score"),
                "config": costs.instrument(self._fit_count_folds,
                                           "scores.config",
                                           cost_fields=fields),
                "plan": costs.instrument(self._plan_members,
                                         "scores.plan_batch",
                                         cost_fields=fields,
                                         key=_plan_key),
                "fit_batch": costs.instrument(self._fit_groups,
                                              "scores.fit_batch",
                                              cost_fields=fields,
                                              key=_shard_key),
                "score_batch": costs.instrument(self._count_groups,
                                                "scores.score_batch",
                                                key=_shard_key),
                "config_batch": costs.instrument(fit_count_groups,
                                                 "scores.config_batch",
                                                 cost_fields=fields,
                                                 key=_shard_key),
            }
        return fns

    def _fit_fold(self, p, fold_key, train_mask, tree_chunk):
        """One fold of the staged path: resample the config's prepared
        matrix ``p`` (``_prepare``) under the fold's training mask, then
        fit the fold's forest."""
        kb, kf = rng.split(fold_key).unbind(0)
        with obs.region("sweep.resample"):
            xs, ys, ws = resample(p["xp"], p["y"], train_mask, p["bal_code"],
                                  kb, p["cap"])
        if p["use_hist"]:
            return trees.fit_forest_hist(xs, ys, ws, kf, edges=p["edges"],
                                         tree_chunk=tree_chunk,
                                         **p["fit_kw"])
        return trees.fit_forest(xs, ys, ws, kf, tree_chunk=tree_chunk,
                                **p["fit_kw"])

    def _stage_wall(self, timings, stage, t0):
        """In timed mode, wait for the device, then add the wall since
        ``t0`` to ``timings[stage]``; nothing otherwise."""
        if timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timings[stage] += time.time() - t0

    def _score_fold(self, p, forest, test_mask, timings=None):
        """One fold's per-project counts, int32 [1, P, 3] on the host: one
        host read a fold, so that the fold is journaled before the next
        one runs (the staged path's resume granularity). ``timings``
        (``run_config``'s timed mode) gets the device part and the host
        read apart."""
        t0 = time.time()
        counts = confusion_by_project(
            p["y"], trees.predict(forest, p["xp"])[None], test_mask,
            self.project_ids, len(self.project_names))
        self._stage_wall(timings, "score_s", t0)
        t1 = time.time()
        counts = counts.cpu().numpy()
        if timings is not None:
            timings["counts_to_host_s"] += time.time() - t1
        return counts

    def _count_done(self, n_configs, n_trees):
        """Throughput counters after a config (or a plan's members)
        completes; no-ops when telemetry is off."""
        obs.counter_add("configs", n_configs)
        obs.counter_add("folds", n_configs * self.n_folds)
        obs.counter_add("trees", n_configs * self.n_folds * n_trees)

    def _batch_bounds(self, n_trees, use_hist, n_configs=1):
        """``batch_bounds`` under this engine's dispatch bounds."""
        return batch_bounds(n_trees, use_hist, self.dispatch_trees,
                            self.dispatch_folds, n_configs, self.n_folds)

    def _fit_groups(self, configs, card, **grow_kw):
        """The fold-batched fit of ``configs`` (one family) on ``card``:
        each config prepared and its folds resampled in turn, then the
        configs x folds grown as tree batches (``_batch_bounds``) on the
        growers' group axis, group c * n_folds + f being fold f of config
        c; on the histogram grower each group reads its config's bin
        edges. ``grow_kw`` are extra keywords of the hist grower
        (``run_plan``'s tuned ``node_batch``). Returns (the forest, with
        [configs x folds, n_trees, ...] leading axes, the configs'
        ``_prepare`` dicts)."""
        preps = [self._prepare(k, card) for k in configs]
        xs, ys, ws, kfs = [], [], [], []
        for keys, p in zip(configs, preps):
            fold_keys = self._fold_keys(keys, card.device)
            train_mask = card.masks[keys[0]][0]
            for f in range(self.n_folds):
                kb, kf = rng.split(fold_keys[f]).unbind(0)
                with obs.region("sweep.resample"):
                    for out, t in zip((xs, ys, ws), resample(
                            p["xp"], p["y"], train_mask[f], p["bal_code"],
                            kb, p["cap"])):
                        out.append(t)
                kfs.append(kf)
        p = preps[0]
        tree_chunk, fold_chunk = self._batch_bounds(
            p["fit_kw"]["n_trees"], p["use_hist"], len(configs))
        args = [torch.stack(t) for t in (xs, ys, ws, kfs)]
        kw = dict(p["fit_kw"], tree_chunk=tree_chunk, fold_chunk=fold_chunk)
        if not p["use_hist"]:
            return trees.fit_folds(*args, **kw), preps
        edges = p["edges"] if len(configs) == 1 else torch.stack(
            [q["edges"] for q in preps]).repeat_interleave(self.n_folds, 0)
        return trees.fit_folds_hist(*args, edges=edges, **kw,
                                    **grow_kw), preps

    def _count_groups(self, configs, card, forest, preps):
        """Each config's per-fold counts, int32 [n_folds, P, 3] on
        ``card``, from ``_fit_groups``' forest: its folds' forests
        predicted as one batch on its own preprocessed matrix."""
        out = []
        for c, (keys, p) in enumerate(zip(configs, preps)):
            if len(configs) > 1:
                part = slice(c * self.n_folds, (c + 1) * self.n_folds)
                forest_c = trees.Forest(*(f[part] for f in forest[:-1]),
                                        forest.max_depth)
            else:
                forest_c = forest
            pred = trees.predict_batch(forest_c, p["xp"])
            with obs.region("sweep.counts"):
                out.append(confusion_by_fold(
                    p["y"], pred, card.masks[keys[0]][1], card.project_ids,
                    len(self.project_names)))
        return out

    def _fit_count_folds(self, config_keys, card=None, **grow_kw):
        """The fold-batched fit of one config on ``card`` (default the
        first): its folds grown as one tree batch (``_fit_groups``), the
        forests predicted as one batch, and the per-fold counts read with
        one host read. Returns the counts, int32 [n_folds, P, 3], each row
        equal to the default path's count of that fold."""
        card = card or self._cards[0]
        forest, preps = self._fit_groups([config_keys], card, **grow_kw)
        counts = self._count_groups([config_keys], card, forest, preps)[0]
        with obs.region("sweep.counts"):
            return counts.cpu().numpy()

    def _shards(self, n_slots, width):
        """The contiguous shards of ``width`` slots, one a card (the JAX
        package's ``P("config")``), of a batch's first ``n_slots`` slots:
        [(card, [slot, ...]), ...], cards with no slot left out."""
        return [(card, list(range(s * width, min((s + 1) * width, n_slots))))
                for s, card in enumerate(self._cards) if s * width < n_slots]

    def run_config_batch(self, config_batch):
        """Run a batch of same-family configs across the device list and
        return their results in ``run_config``'s schema. The batch is
        padded to a multiple of the card count with its first config and
        cut into contiguous shards, one a card (``batch_layout``); each
        card grows its shard's configs x folds as tree batches on the
        group axis (``_fit_groups``: one BFS step or one level serves
        every config of the shard), under ``TREES_IN_FLIGHT`` over configs
        x folds x trees when no dispatch bound is given. A padded slot
        repeats the first config, which the card holding it runs again:
        wasted work the real configs bear. Under a ``group`` the card
        count is every rank's, this rank runs its contiguous share of the
        shards, and the ranks' host counts are all-gathered
        (``ProcessGroup.gather``), so every rank returns the whole batch;
        a rank that fails makes every rank raise (``RankFailed``). A
        journal is refused there: the cross-process batch is journal-free.

        Staged (default): a ``scores.fit_batch`` span over the fit on
        every card, then a ``scores.score_batch`` span over the counts,
        [B, P, 3] to the host, or with a journal [B, folds, P, 3], every
        real config's folds journaled and then its config record, totals
        the int32 fold sum. Fused: one ``scores.config_batch`` span and one
        combined wall in T_TRAIN, T_TEST = 0.0, and only the config
        records journaled. The walls, the calling rank's (T_TEST, or the
        combined wall, includes the gather), are attributed evenly over
        the real configs, which join ``amortized_configs``: per-config
        times of a shared batch are not separable. Counts equal
        ``run_config``'s bit for bit."""
        config_batch = [tuple(k) for k in config_batch]
        fs_name, model_name = config_batch[0][1], config_batch[0][4]
        if any((k[1], k[4]) != (fs_name, model_name) for k in config_batch):
            raise ValueError("run_config_batch takes one family's configs")
        group = self.group
        if group is not None and self.journal is not None:
            raise ValueError("a config batch across processes is "
                             "journal-free: detach the journal")
        world, rank = (1, 0) if group is None else (group.world_size,
                                                    group.rank)
        n_cards = len(self._cards)
        padded, layout = batch_layout(config_batch, world * n_cards)
        shards = list(zip(self._cards, layout[rank * n_cards:
                                              (rank + 1) * n_cards]))
        n_real = len(config_batch)
        family = (fs_name, model_name)
        span_kw = dict(key=(*family, "fused" if self.fused else "staged",
                            len(padded)), batch=n_real,
                       configs=["/".join(k) for k in config_batch])
        journal = self.journal
        per_fold = journal is not None and not self.fused
        fit_done = []

        fns = self._family_fns(config_batch[0])

        def host_counts(counts):
            counts = torch.stack(counts)
            if not per_fold:
                counts = counts.sum(1, dtype=torch.int32)
            return counts.cpu().numpy()

        def counts_of(card, shard, fitted):
            return host_counts(fns["score_batch"](shard, card, *fitted))

        def fit(card, shard):
            fitted = fns["fit_batch"](shard, card)
            if card.device.type == "cuda":  # the batch's train clock
                torch.cuda.synchronize(card.device)
            return fitted

        def local():
            """This rank's counts, its shards' in order, on the host."""
            if self.fused:
                with obs.span("scores.config_batch", counts=launch_counts,
                              mode="fused", stage="fused", **span_kw):
                    got = _on_cards([(card, [
                        lambda card=card, shard=shard: host_counts(
                            fns["config_batch"](shard, card))])
                        for card, shard in shards])
            else:
                with obs.span("scores.fit_batch", counts=launch_counts,
                              mode="staged", stage="fit", **span_kw):
                    fitted = _on_cards([(card, [
                        lambda card=card, shard=shard: fit(card, shard)])
                        for card, shard in shards])
                    fit_done.append(time.time())
                with obs.span("scores.score_batch", mode="staged",
                              stage="predict", **span_kw):
                    got = _on_cards([(card, [
                        lambda card=card, shard=shard, f=f[0]: counts_of(
                            card, shard, f)])
                        for (card, shard), f in zip(shards, fitted)])
                    del fitted
            return np.concatenate([r[0] for r in got])

        t0 = time.time()
        if group is None:
            counts = local()
        else:
            counts = np.concatenate(group.gather(local))
            if len(counts) != len(padded):
                raise RuntimeError(
                    f"the ranks ran {len(counts)} slots of {len(padded)}: "
                    f"every rank must drive {n_cards} card(s)")
        t1 = time.time()
        counts = counts[:n_real]
        if self.fused:
            wall = (t1 - t0) / n_real
            out = [self._result(counts[i], wall / self.n_folds, 0.0)
                   for i in range(n_real)]
            self.fused_configs.update(config_batch)
        else:
            by_fold = counts if per_fold else None
            if by_fold is not None:
                counts = by_fold.sum(1, dtype=np.int32)
            t_train = (fit_done[0] - t0) / n_real
            t_test = (t1 - fit_done[0]) / n_real
            out = [self._result(counts[i], t_train / self.n_folds,
                                t_test / self.n_folds)
                   for i in range(n_real)]
        self._count_done(n_real, self._spec(model_name).n_trees)
        self.amortized_configs.update(config_batch)
        if journal is not None:
            for i, keys in enumerate(config_batch):
                if not self.fused:
                    self._journal_folds(keys, by_fold[i])
                journal.record_config(keys, out[i])
        return out

    def _journal_folds(self, config_keys, counts):
        """Journal a config's fold records, counts [n_folds, P, 3]."""
        key_bytes = _key_bytes(self._fold_keys(config_keys))
        index = self._index[config_keys]
        for f in range(self.n_folds):
            self.journal.record_fold(config_keys, f, key_bytes[f],
                                     counts[f], config_index=index)

    def _member_result(self, config_keys, counts, wall):
        """A plan member's result with its own combined wall (T_TEST =
        0.0); its fold records, then its config record, are journaled."""
        result = self._result(counts.sum(0, dtype=np.int32),
                              wall / self.n_folds, 0.0)
        if self.journal is not None:
            self._journal_folds(config_keys, counts)
            self.journal.record_config(config_keys, result)
        return result

    def _run_member(self, config_keys, grow_kw):
        """One plan member through the fold-batched fit on the first card
        (``grow_kw``: the hist grower's extra keywords), journaled before
        it returns (``_member_result``)."""
        t0 = time.time()
        counts = self._fit_count_folds(config_keys, **grow_kw)
        return self._member_result(config_keys, counts, time.time() - t0)

    def plan_grow_kw(self, plan):
        """The hist grower's extra keywords for ``plan``: the performance
        database's tuned window width at the plan's shape
        (``perfdb.tuned_fit_overrides``, sanitized there to K1's
        shared-memory bound), asked once a plan; {} for the exact
        grower or without a usable row."""
        model_name = plan.family[1]
        if not trees.hist_tier_default(self._spec(model_name).n_trees,
                                       self.grower):
            return {}
        return perfdb.tuned_fit_overrides(self.device.type, plan.shape,
                                          model=model_name)

    def run_plan(self, plan, guard, grow_kw, n_cards=None):
        """Run a ``planner.Plan``'s members, each through the fold-batched
        fit, so each keeps its own step count: on one card one after
        another (the port's analogue of the JAX package's ``lax.map``
        over a plan), else split over the cards (``_run_plan_cards``;
        ``n_cards=1`` holds the plan to the first card, as ``run_grid``
        does under device-fault injection). Returns the members' results
        in ``run_config``'s schema, None for a quarantined member. The
        plan is one ``scores.plan`` span (and, with ``F16_XPROF``, one
        profiler capture a model).

        On one card each member is a guarded call of its own under
        ``guard`` (a ``DispatchGuard``): a fault, a retry or an overrun
        touches that member alone, the injection plan addresses it by its
        config index, and a member the guard abandons is quarantined.
        Each member's folds are journaled, then its config record, before
        the next member runs. The journal holds a member's own wall; the
        results hold the plan's clocks amortized over the members that
        ran (combined: T_TEST = 0.0), as the JAX package's, and those
        members join ``fused_configs`` (and, for a plan of more than one
        config, ``amortized_configs``).

        ``grow_kw`` are the hist grower's extra keywords
        (``plan_grow_kw``, which the pre-flight read too): a tuned window
        width never changes a forest, and without one (or with the width
        pinned by the operator) the grower keeps its own
        (``trees.default_node_batch``). The exact grower takes none."""
        fs_name, model_name = plan.family
        n_cards = n_cards or len(self._cards)
        with obs.span("scores.plan", key=(fs_name, model_name, plan.batch),
                      counts=launch_counts, stage="plan",
                      batch=len(plan.configs), pad=plan.pad,
                      configs=["/".join(k) for k in plan.configs]):
            with obs.xprof_trace(f"plan-{model_name.replace(' ', '_')}",
                                 self.device):
                own, ran_plan, wall = self._family_fns(
                    plan.configs[0])["plan"](plan, guard, grow_kw, n_cards)
        ran = [(k, r) for k, r, p in zip(plan.configs, own, ran_plan)
               if p and r is not None]
        self._count_done(len(ran), self._spec(model_name).n_trees)
        if not ran:
            return own
        if wall is None:
            wall = sum(r[0] for _, r in ran) / len(ran)
        self.fused_configs.update(k for k, _ in ran)
        if len(plan.configs) > 1:
            self.amortized_configs.update(k for k, _ in ran)
        return [[wall, 0.0, *r[2:]] if p else r
                for r, p in zip(own, ran_plan)]

    def _plan_members(self, plan, guard, grow_kw, n_cards):
        """``run_plan``'s members: (results, whether each member's result
        is the plan's, the plan's wall or None)."""
        if n_cards > 1:
            return self._run_plan_cards(plan, guard, grow_kw)
        own = [self._run_guarded(
            guard, keys, lambda keys=keys: self._run_member(keys, grow_kw))
            for keys in plan.configs]
        return own, [r is not None for r in own], None

    def _run_plan_cards(self, plan, guard, grow_kw):
        """``plan``'s members split over the cards: card s runs the real
        members of the padded batch's s-th contiguous shard one after
        another (pads never run), so one member is in flight on a card.
        The whole plan is one guarded call, as the JAX
        package's plan dispatch is; a member that finished in an earlier
        attempt of it is not run again. The calling thread journals each
        member (``_member_result``) as soon as every member before it
        has, so the journal keeps canonical member order and a kill
        leaves a prefix. A plan the guard abandons is salvaged config by
        config on ``run_config``'s path, counted in ``retries``. Returns
        (results, whether each ran on the plan path, the plan's wall a
        fold amortized over its members)."""
        members = list(plan.configs)
        done = {}                   # member -> (counts, wall), all attempts
        journaled = []

        def member(card, m):
            t0 = time.time()
            counts = self._fit_count_folds(members[m], card=card, **grow_kw)
            return m, counts, time.time() - t0

        def landed(job, i, res):
            m, counts, wall = res
            done[m] = (counts, wall)
            while len(journaled) in done and len(journaled) < len(members):
                k = len(journaled)
                journaled.append(self._member_result(members[k],
                                                     *done[k]))

        def thunk():
            jobs = []
            for card, slots in self._shards(
                    len(members), plan.batch // len(self._cards)):
                todo = [m for m in slots if m not in done]
                if todo:
                    jobs.append((card, [
                        lambda card=card, m=m: member(card, m)
                        for m in todo]))
            _on_cards(jobs, landed)
            return list(journaled)

        t0 = time.time()
        try:
            own = guard.call(thunk, label=f"plan/{'/'.join(plan.family)}")
        except rguard.DispatchAbandoned as e:
            self._salvaged(e, len(members) - len(journaled))
            own = journaled + [self._run_guarded(
                guard, keys, lambda keys=keys: self.run_config(keys))
                for keys in members[len(journaled):]]
            ran = [i < len(journaled) for i in range(len(members))]
            return own, ran, ((time.time() - t0) / max(1, len(journaled))
                              / self.n_folds)
        wall = (time.time() - t0) / len(members) / self.n_folds
        return own, [True] * len(members), wall

    def _salvaged(self, e, n_configs):
        """Record a batch or a plan that the guard abandoned, salvaged
        config by config (the JAX package's behaviour), in ``retries``."""
        self.retries.append(dict(e.attempts[-1], label=e.label,
                                 salvaged=n_configs))

    def _run_guarded(self, guard, keys, thunk):
        """``thunk`` (one config's run) under the guard; None when the
        config was quarantined."""
        try:
            return guard.call(thunk, config_index=self._index.get(keys),
                              label="/".join(keys))
        except rguard.DispatchAbandoned as e:
            self.quarantined[keys] = {"fault_class": e.fault_class,
                                      "attempts": e.attempts}
            obs.event("fault", fault_class=e.fault_class,
                      action="quarantine", attempt=len(e.attempts),
                      config="/".join(keys))
            return None

    def run_grid(self, config_list=None, ledger=None, progress=None,
                 batch_size=None):
        """Run many configs (default: the whole grid); returns
        {config_keys: result}. Configs already in ``ledger`` are skipped;
        ``progress(i, n, keys, scores)`` is called after each config.

        Each config runs under the dispatch guard: a transient fault is
        retried with backoff, and a config that exhausts its attempts (or
        fails deterministically) is left out of the result and recorded
        in ``self.quarantined``; the sweep goes on. The injection plan
        addresses configs by their index in the canonical grid order.

        ``batch_size`` is the width of a config batch (default: the card
        count). Above 1, configs journaled in part resume first on
        ``run_config``'s fold-granular path, then the rest run in batches
        of one family (``iter_family_batches``), each batch one guarded
        call (``run_config_batch``); a batch of one config takes the
        per-config path, and a batch the guard abandons is salvaged config
        by config. An injection plan with device faults forces width 1
        (and plans onto the first card), so a fault stays at one config.
        With ``planner_mode`` the journaled configs resume first, then the
        rest run as plans (one a family, ``planner.plan_grid``'s order,
        padded to the card count, ``run_plan``). Between the two, the
        budget pre-flight (``_preflight_plan_budget``) may refuse every
        plan with ``PlanOverBudget`` before the first one dispatches."""
        if self.group is not None:
            raise ValueError(
                "run_grid runs in one process: across processes, run one "
                "config batch at a time (run_config_batch)")
        scores = dict(ledger or {})
        if config_list is None:
            config_list = cfg.iter_config_keys()
        todo = [tuple(k) for k in config_list if tuple(k) not in scores]
        inject = rinject.plan_from_env()
        guard = rguard.default_guard(
            plan=inject,
            device=self.devices if len(self.devices) > 1 else self.device)
        self.retries = guard.retries
        device_faults = inject is not None and any(
            fc not in rinject.PROCESS_CLASSES for _, _, fc in inject.entries)
        n_cards = 1 if device_faults else len(self._cards)
        width = 1 if device_faults else (
            len(self._cards) if batch_size is None else batch_size)
        done = []

        def put(keys, res):
            if res is not None:
                scores[keys] = res
            done.append(keys)
            if progress is not None:
                progress(len(done), len(todo), keys, scores)

        def one(keys):
            return self._run_guarded(guard, keys,
                                     lambda: self.run_config(keys))

        batched = self.planner_mode or width > 1
        single = [k for k in todo if not batched or (
            self.journal is not None and self.journal.partial_folds(k))]
        for keys in single:
            put(keys, one(keys))
        resumed = set(single)
        rest = [k for k in todo if k not in resumed]
        if not self.planner_mode:
            for batch in iter_family_batches(rest, max(1, width)):
                if len(batch) == 1:
                    results = [one(batch[0])]
                else:
                    try:
                        results = guard.call(
                            lambda batch=batch: self.run_config_batch(batch),
                            label=f"batch/{batch[0][1]}/{batch[0][4]}")
                    except rguard.DispatchAbandoned as e:
                        self._salvaged(e, len(batch))
                        results = [one(k) for k in batch]
                for keys, res in zip(batch, results):
                    put(keys, res)
            return scores
        # The performance database's recorded plan padding (``perfdb.
        # plan_lookup``; None without a database): a pad only widens the
        # Plan record, since pads never run.
        plans = planner.plan_grid(
            rest, devices=n_cards, n=self.features.shape[0],
            n_folds=self.n_folds, tree_overrides=self.tree_overrides,
            perf_lookup=perfdb.plan_lookup(self.device.type))
        grow_kws = [self.plan_grow_kw(pl) for pl in plans]
        if self.preflight:
            _preflight_plan_budget(
                plans, n_projects=len(self.project_names),
                max_depth=self.max_depth, grower=self.grower,
                device_type=self.device.type, grow_kws=grow_kws,
                dispatch_trees=self.dispatch_trees,
                dispatch_folds=self.dispatch_folds)
        for pl, kw in zip(plans, grow_kws):
            # n_cards only when device faults hold the plans to one card
            res = self.run_plan(pl, guard, kw) if n_cards == len(
                self._cards) else self.run_plan(pl, guard, kw, n_cards)
            for keys, r in zip(pl.configs, res):
                put(keys, r)
        return scores


def batch_layout(config_batch, n_cards):
    """(the batch padded to a multiple of ``n_cards`` with its first
    config, its contiguous shards, one a card in the cards' global order
    (process-major across ranks: rank r's cards are r * local .. (r + 1)
    * local - 1)). The JAX package's ``P("config")`` placement."""
    padded = list(config_batch) + [config_batch[0]] * (
        -len(config_batch) % n_cards)
    width = len(padded) // n_cards
    return padded, [padded[c * width:(c + 1) * width]
                    for c in range(n_cards)]


def iter_family_batches(configs, batch_size):
    """Group configs by family (feature set, model) and yield them in
    batches of at most ``batch_size``, families in the order of their
    first config (the JAX package's, which its bench's batch mode
    shares)."""
    families = {}
    for keys in configs:
        families.setdefault((keys[1], keys[4]), []).append(keys)
    for fam_configs in families.values():
        for lo in range(0, len(fam_configs), batch_size):
            yield fam_configs[lo:lo + batch_size]
