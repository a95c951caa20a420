"""The per-config CV pipeline: preprocess -> bin edges (once per config,
histogram grower only) -> per fold: resample -> fit -> predict ->
per-project confusion. The folds are stratified (10) or leave one project
out (one a project).

Keys follow the JAX package exactly: the config key is
``fold_in(PRNGKey(SEED), config_index)`` over the canonical grid order;
fold keys are ``split(config_key, n_folds)``; each fold key splits into the
resampler's key and the forest's key. An ensemble grows on the histogram
grower and the single Decision Tree on the exact grower
(``trees.hist_tier_default``; ``grower="exact"`` or
``F16_ENSEMBLE_GROWER=exact`` puts ensembles on the exact grower too).

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
  so each keeps its own step count.

With a write-ahead journal (``resilience/journal.py``) attached, a config
resumes at fold granularity: the folds already journaled with matching
keys are taken as they are, only the missing folds are fit. ``run_grid``
runs every config, and every plan member, under the dispatch guard
(``resilience/guard.py``) as a call of its own and quarantines a config
that exhausts its attempts.
"""

import time

import numpy as np
import torch

from flake16_framework_tpu_torch import config as cfg, rng
from flake16_framework_tpu_torch.device import resolve
from flake16_framework_tpu_torch.ops import trees
from flake16_framework_tpu_torch.ops.metrics import (
    confusion_by_fold, confusion_by_project, format_scores,
)
from flake16_framework_tpu_torch.ops.preprocess import fit_preprocess, transform
from flake16_framework_tpu_torch.ops.resample import resample
from flake16_framework_tpu_torch.parallel import planner
from flake16_framework_tpu_torch.parallel.folds import (
    fold_masks, lopo_fold_masks,
)
from flake16_framework_tpu_torch.resilience import guard as rguard
from flake16_framework_tpu_torch.resilience import inject as rinject

N_FOLDS = 10
SEED = 0  # the config keys' root seed, as the reference's

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


def _key_bytes(fold_keys):
    """Each fold key's journal bytes, as the JAX package writes them: the
    key's two uint32 words, little-endian."""
    return [k.tobytes() for k in fold_keys.cpu().numpy().astype("<u4")]


class SweepEngine:
    """Host driver of the grid on one device: ``run_config`` returns the
    reference ``scores.pkl`` value ``[t_train, t_test, scores,
    scores_total]``; ``run_grid`` runs many configs. ``cv="lopo"`` runs
    leave-one-project-out CV, one fold a project. ``journal`` (a
    ``SweepJournal``, or None) makes configs fold-granular; configs that
    ``run_grid`` quarantined are in ``quarantined`` ({keys:
    {"fault_class", "attempts"}}), and the faults it recovered from in
    ``retries``.

    ``fused=True`` runs each config through the fold-batched fit, with the
    config's combined wall in T_TRAIN (T_TEST = 0.0); ``planner_mode=True``
    makes ``run_grid`` run plans (``run_plan``). Configs with combined
    clocks are listed in ``fused_configs``, those with plan-amortized
    clocks in ``amortized_configs`` (``pipeline`` writes both beside the
    pickle). ``dispatch_trees``/``dispatch_folds`` bound the trees and
    folds a batch grows; ``grower`` is the ensembles' grower
    (``trees.ensemble_grower``)."""

    def __init__(self, features, labels_raw, projects, project_names,
                 project_ids, *, max_depth=48, tree_overrides=None,
                 cv="stratified", device=None, fused=False,
                 planner_mode=False, dispatch_trees=None,
                 dispatch_folds=None, grower=None):
        self.device = resolve(device)
        trees.ensemble_grower(grower)               # a bad value raises now
        self.grower = grower
        self.fused = fused
        self.planner_mode = planner_mode
        self.dispatch_trees = dispatch_trees
        self.dispatch_folds = dispatch_folds
        self.features = np.asarray(features, dtype=np.float32)
        self.labels_host = np.asarray(labels_raw, np.int32)
        self.labels_raw = torch.as_tensor(self.labels_host,
                                          device=self.device)
        self.projects = projects
        self.project_names = project_names
        self.project_ids = torch.as_tensor(
            np.asarray(project_ids, np.int32), device=self.device)
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
        self._masks = {
            fl_name: tuple(torch.as_tensor(m, device=self.device) for m in mm)
            for fl_name, mm in masks.items()}
        self._index = planner.canonical_indices()
        self.journal = None
        self.quarantined = {}
        self.retries = []
        self.fused_configs = set()
        self.amortized_configs = set()

    def _spec(self, model_name):
        spec = cfg.MODELS[model_name]
        if model_name in self.tree_overrides:
            spec = type(spec)(spec.name, self.tree_overrides[model_name],
                              spec.bootstrap, spec.random_splits,
                              spec.sqrt_features)
        return spec

    def _prepare(self, config_keys):
        """What every fold of a config shares: the preprocessed matrix, the
        labels, the bin edges (histogram grower: once per config, from the
        full preprocessed matrix), the fold keys and the fit's keywords."""
        fl_label, cols, prep_code, bal_code, _ = cfg.resolve_config(
            config_keys)
        spec = self._spec(config_keys[4])
        dev = self.device
        x = torch.as_tensor(self.features[:, list(cols)], device=dev)
        cap = 2 * x.shape[0]  # SMOTE at worst doubles the training set
        y = self.labels_raw == fl_label
        mu, wmat = fit_preprocess(x, prep_code)
        xp = transform(x, mu, wmat)
        use_hist = trees.hist_tier_default(spec.n_trees, self.grower)
        edges = trees.quantile_edges(xp) if use_hist else None
        fit_kw = dict(n_trees=spec.n_trees, bootstrap=spec.bootstrap,
                      random_splits=spec.random_splits,
                      sqrt_features=spec.sqrt_features,
                      max_depth=self.max_depth, max_nodes=2 * cap)
        return dict(y=y, xp=xp, edges=edges, use_hist=use_hist, cap=cap,
                    bal_code=bal_code, fold_keys=self._fold_keys(config_keys),
                    fit_kw=fit_kw)

    def _fold_keys(self, config_keys):
        """The config's fold keys [n_folds, 2]: ``split(fold_in(
        PRNGKey(SEED), config index), n_folds)``."""
        key = rng.fold_in(rng.prng_key(SEED, self.device),
                          self._index[tuple(config_keys)])
        return rng.split(key, self.n_folds)

    def _result(self, counts, t_train, t_test):
        scores, scores_total = format_scores(counts, self.project_names,
                                             self.projects)
        return [t_train, t_test, scores, scores_total]

    def run_config(self, config_keys):
        """One config's CV; returns [t_train, t_test, scores,
        scores_total] (per-fold mean walls). With ``fused``, the config
        runs through the fold-batched fit and only its config record is
        journaled, as in the JAX package's fused path."""
        config_keys = tuple(config_keys)
        if self.fused:
            t0 = time.time()
            counts = self._fit_count_folds(config_keys)
            result = self._result(counts.sum(0, dtype=np.int32),
                                  (time.time() - t0) / self.n_folds, 0.0)
            self.fused_configs.add(config_keys)
            if self.journal is not None:
                self.journal.record_config(config_keys, result)
            return result

        cfg_index = self._index[config_keys]
        train_mask, test_mask = self._masks[config_keys[0]]
        t0 = time.time()
        p = self._prepare(config_keys)
        tree_chunk = self.dispatch_trees
        # Journal resume state: folds already journaled for this config
        # with matching key bytes are trusted and not refit.
        journal = self.journal
        counts_by_fold = {}
        if journal is not None:
            key_bytes = _key_bytes(p["fold_keys"])
            for f, (kb, cnt) in journal.partial_folds(config_keys).items():
                if 0 <= int(f) < self.n_folds and \
                        bytes(kb) == key_bytes[int(f)]:
                    counts_by_fold[int(f)] = np.asarray(cnt)
        t_train = time.time() - t0
        t_test = 0.0
        # Each missing fold is fit, predicted and counted (one host read),
        # then journaled, so a kill loses at most the fold in flight.
        for f in range(self.n_folds):
            if f in counts_by_fold:
                continue
            t0 = time.time()
            kb, kf = rng.split(p["fold_keys"][f]).unbind(0)
            xs, ys, ws = resample(p["xp"], p["y"], train_mask[f],
                                  p["bal_code"], kb, p["cap"])
            if p["use_hist"]:
                forest = trees.fit_forest_hist(
                    xs, ys, ws, kf, edges=p["edges"], tree_chunk=tree_chunk,
                    **p["fit_kw"])
            else:
                forest = trees.fit_forest(xs, ys, ws, kf,
                                          tree_chunk=tree_chunk,
                                          **p["fit_kw"])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.time()
            counts_by_fold[f] = confusion_by_project(
                p["y"], trees.predict(forest, p["xp"])[None],
                test_mask[f:f + 1], self.project_ids,
                len(self.project_names)).cpu().numpy()
            t_train += t1 - t0
            t_test += time.time() - t1
            if journal is not None:
                journal.record_fold(config_keys, f, key_bytes[f],
                                    counts_by_fold[f], config_index=cfg_index)
        counts = np.sum([counts_by_fold[f] for f in range(self.n_folds)],
                        axis=0, dtype=np.int32)
        result = self._result(counts, t_train / self.n_folds,
                              t_test / self.n_folds)
        if journal is not None:
            journal.record_config(config_keys, result)
        return result

    def _batch_bounds(self, n_trees, use_hist):
        """(trees, folds) a tree batch of the fold-batched fit holds at
        most: the dispatch bounds where given, else as many as
        ``TREES_IN_FLIGHT`` allows. ``dispatch_folds`` is the JAX
        package's keyword; no entry point of the port sets it (the CLI's
        ``dispatch=N`` is ``dispatch_trees``)."""
        budget = TREES_IN_FLIGHT["hist" if use_hist else "exact"]
        tree_chunk = self.dispatch_trees or min(n_trees, budget)
        return tree_chunk, self.dispatch_folds or max(1, budget // tree_chunk)

    def _fit_count_folds(self, config_keys):
        """The fold-batched fit of one config: each fold resampled in
        turn, then their trees grown as tree batches (``_batch_bounds``),
        the forests predicted as one batch, and the per-fold counts read
        with one host read. Returns the counts, int32 [n_folds, P, 3],
        each row equal to the default path's count of that fold."""
        p = self._prepare(config_keys)
        train_mask, test_mask = self._masks[config_keys[0]]
        xs, ys, ws, kfs = [], [], [], []
        for f in range(self.n_folds):
            kb, kf = rng.split(p["fold_keys"][f]).unbind(0)
            for out, t in zip((xs, ys, ws), resample(
                    p["xp"], p["y"], train_mask[f], p["bal_code"], kb,
                    p["cap"])):
                out.append(t)
            kfs.append(kf)
        tree_chunk, fold_chunk = self._batch_bounds(p["fit_kw"]["n_trees"],
                                                    p["use_hist"])
        args = [torch.stack(t) for t in (xs, ys, ws, kfs)]
        kw = dict(p["fit_kw"], tree_chunk=tree_chunk, fold_chunk=fold_chunk)
        if p["use_hist"]:
            forest = trees.fit_folds_hist(*args, edges=p["edges"], **kw)
        else:
            forest = trees.fit_folds(*args, **kw)
        return confusion_by_fold(
            p["y"], trees.predict_batch(forest, p["xp"]), test_mask,
            self.project_ids, len(self.project_names)).cpu().numpy()

    def _run_member(self, config_keys, config_index):
        """One plan member through the fold-batched fit; its fold records,
        then its config record, are journaled before it returns. Returns
        its result with its own combined wall (T_TEST = 0.0)."""
        t0 = time.time()
        counts = self._fit_count_folds(config_keys)
        result = self._result(counts.sum(0, dtype=np.int32),
                              (time.time() - t0) / self.n_folds, 0.0)
        if self.journal is not None:
            key_bytes = _key_bytes(self._fold_keys(config_keys))
            for f in range(self.n_folds):
                self.journal.record_fold(config_keys, f, key_bytes[f],
                                         counts[f], config_index=config_index)
            self.journal.record_config(config_keys, result)
        return result

    def run_plan(self, plan, guard):
        """Run a ``planner.Plan``'s members one after another (the port's
        analogue of the JAX package's ``lax.map`` over a plan), each
        through the fold-batched fit, so each keeps its own step count.
        Each member is a guarded call of its own under ``guard`` (a
        ``DispatchGuard``): a fault, a retry or an overrun touches that
        member alone, the injection plan addresses it by its config
        index, and a member the guard abandons is quarantined and its
        result None. Returns the members' results in ``run_config``'s
        schema.

        Each member's folds are journaled, then its config record, before
        the next member runs. The journal holds a member's own wall; the
        results hold the plan's clocks amortized over the members that
        ran (combined: T_TEST = 0.0), as the JAX package's, and those
        members join ``fused_configs`` (and, for a plan of more than one
        config, ``amortized_configs``)."""
        own = [self._run_guarded(
            guard, keys, lambda keys=keys, index=index: self._run_member(
                keys, index))
            for keys, index in zip(plan.configs, plan.indices)]
        ran = [(k, r) for k, r in zip(plan.configs, own) if r is not None]
        if not ran:
            return own
        wall = sum(r[0] for _, r in ran) / len(ran)
        self.fused_configs.update(k for k, _ in ran)
        if len(plan.configs) > 1:
            self.amortized_configs.update(k for k, _ in ran)
        return [None if r is None else [wall, 0.0, *r[2:]] for r in own]

    def _run_guarded(self, guard, keys, thunk):
        """``thunk`` (one config's run) under the guard; None when the
        config was quarantined."""
        try:
            return guard.call(thunk, config_index=self._index.get(keys),
                              label="/".join(keys))
        except rguard.DispatchAbandoned as e:
            self.quarantined[keys] = {"fault_class": e.fault_class,
                                      "attempts": e.attempts}
            return None

    def run_grid(self, config_list=None, ledger=None, progress=None):
        """Run many configs (default: the whole grid); returns
        {config_keys: result}. Configs already in ``ledger`` are skipped;
        ``progress(i, n, keys, scores)`` is called after each config.

        Each config runs under the dispatch guard: a transient fault is
        retried with backoff, and a config that exhausts its attempts (or
        fails deterministically) is left out of the result and recorded
        in ``self.quarantined``; the sweep goes on. The injection plan
        addresses configs by their index in the canonical grid order.
        With ``planner_mode`` configs with journaled folds resume first,
        on ``run_config``'s fold-granular path; the rest run as plans
        (one a family, ``planner.plan_grid``'s order, ``run_plan``), each
        member guarded as a config of its own."""
        scores = dict(ledger or {})
        if config_list is None:
            config_list = cfg.iter_config_keys()
        todo = [tuple(k) for k in config_list if tuple(k) not in scores]
        guard = rguard.default_guard(plan=rinject.plan_from_env(),
                                     device=self.device)
        self.retries = guard.retries
        done = []

        def put(keys, res):
            if res is not None:
                scores[keys] = res
            done.append(keys)
            if progress is not None:
                progress(len(done), len(todo), keys, scores)

        single = [k for k in todo if not self.planner_mode or (
            self.journal is not None and self.journal.partial_folds(k))]
        for keys in single:
            put(keys, self._run_guarded(
                guard, keys, lambda keys=keys: self.run_config(keys)))
        for pl in planner.plan_grid(
                [k for k in todo if k not in single], devices=1,
                n=self.features.shape[0], n_folds=self.n_folds,
                tree_overrides=self.tree_overrides):
            for keys, res in zip(pl.configs, self.run_plan(pl, guard)):
                put(keys, res)
        return scores
