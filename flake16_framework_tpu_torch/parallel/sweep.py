"""The per-config CV pipeline: preprocess -> bin edges (once per config,
histogram grower only) -> per fold: resample -> fit -> predict ->
per-project confusion. The folds are stratified (10) or leave one project
out (one a project).

Keys follow the JAX package exactly: the config key is
``fold_in(PRNGKey(SEED), config_index)`` over the canonical grid order;
fold keys are ``split(config_key, n_folds)``; each fold key splits into the
resampler's key and the forest's key. Folds run one after another. An
ensemble's trees grow as one tree batch on the histogram grower; the
single Decision Tree grows on the exact grower (``trees.hist_tier_default``).

With a write-ahead journal (``resilience/journal.py``) attached, a config
resumes at fold granularity: the folds already journaled with matching
keys are taken as they are, only the missing folds are fit, and each fold's
counts are journaled the moment they reach the host. ``run_grid`` runs
every config under the dispatch guard (``resilience/guard.py``) and
quarantines a config that exhausts its attempts.
"""

import time

import numpy as np
import torch

from flake16_framework_tpu_torch import config as cfg, rng
from flake16_framework_tpu_torch.device import resolve
from flake16_framework_tpu_torch.ops import trees
from flake16_framework_tpu_torch.ops.metrics import (
    confusion_by_project, format_scores,
)
from flake16_framework_tpu_torch.ops.preprocess import fit_preprocess, transform
from flake16_framework_tpu_torch.ops.resample import resample
from flake16_framework_tpu_torch.parallel.folds import (
    fold_masks, lopo_fold_masks,
)
from flake16_framework_tpu_torch.resilience import guard as rguard
from flake16_framework_tpu_torch.resilience import inject as rinject

N_FOLDS = 10
SEED = 0  # the config keys' root seed, as the reference's


class SweepEngine:
    """Host driver of the grid on one device: ``run_config`` returns the
    reference ``scores.pkl`` value ``[t_train, t_test, scores,
    scores_total]``; ``run_grid`` runs many configs. ``cv="lopo"`` runs
    leave-one-project-out CV, one fold a project. ``journal`` (a
    ``SweepJournal``, or None) makes configs fold-granular; configs that
    ``run_grid`` quarantined are in ``quarantined`` ({keys:
    {"fault_class", "attempts"}}), and the faults it recovered from in
    ``retries``."""

    def __init__(self, features, labels_raw, projects, project_names,
                 project_ids, *, max_depth=48, tree_overrides=None,
                 cv="stratified", device=None):
        self.device = resolve(device)
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
        self._index = {k: i for i, k in enumerate(cfg.iter_config_keys())}
        self.journal = None
        self.quarantined = {}
        self.retries = []

    def _spec(self, model_name):
        spec = cfg.MODELS[model_name]
        if model_name in self.tree_overrides:
            spec = type(spec)(spec.name, self.tree_overrides[model_name],
                              spec.bootstrap, spec.random_splits,
                              spec.sqrt_features)
        return spec

    def run_config(self, config_keys):
        """One config's CV; returns [t_train, t_test, scores,
        scores_total] (per-fold mean walls)."""
        config_keys = tuple(config_keys)
        fl_label, cols, prep_code, bal_code, _ = cfg.resolve_config(
            config_keys)
        spec = self._spec(config_keys[4])
        dev = self.device
        x = torch.as_tensor(self.features[:, list(cols)], device=dev)
        n = x.shape[0]
        cap = 2 * n  # SMOTE at worst doubles the training set
        train_mask, test_mask = self._masks[config_keys[0]]

        t0 = time.time()
        y = self.labels_raw == fl_label
        mu, wmat = fit_preprocess(x, prep_code)
        xp = transform(x, mu, wmat)
        use_hist = trees.hist_tier_default(spec.n_trees)
        # Bin edges once per config from the full preprocessed matrix.
        edges = trees.quantile_edges(xp) if use_hist else None
        cfg_index = self._index[config_keys]
        key = rng.fold_in(rng.prng_key(SEED, dev), cfg_index)
        fold_keys = rng.split(key, self.n_folds)
        fit_kw = dict(n_trees=spec.n_trees, bootstrap=spec.bootstrap,
                      random_splits=spec.random_splits,
                      sqrt_features=spec.sqrt_features,
                      max_depth=self.max_depth, max_nodes=2 * cap)
        # Journal resume state: folds already journaled for this config
        # with matching key bytes are trusted and not refit.
        journal = self.journal
        counts_by_fold = {}
        if journal is not None:
            key_bytes = [k.tobytes() for k in
                         fold_keys.cpu().numpy().astype("<u4")]
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
            kb, kf = rng.split(fold_keys[f]).unbind(0)
            xs, ys, ws = resample(xp, y, train_mask[f], bal_code, kb, cap)
            if use_hist:
                forest = trees.fit_forest_hist(xs, ys, ws, kf, edges=edges,
                                               **fit_kw)
            else:
                forest = trees.fit_forest(xs, ys, ws, kf, **fit_kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.time()
            counts_by_fold[f] = confusion_by_project(
                y, trees.predict(forest, xp)[None], test_mask[f:f + 1],
                self.project_ids, len(self.project_names)).cpu().numpy()
            t_train += t1 - t0
            t_test += time.time() - t1
            if journal is not None:
                journal.record_fold(config_keys, f, key_bytes[f],
                                    counts_by_fold[f], config_index=cfg_index)
        counts = np.sum([counts_by_fold[f] for f in range(self.n_folds)],
                        axis=0, dtype=np.int32)
        scores, scores_total = format_scores(counts, self.project_names,
                                             self.projects)
        result = [t_train / self.n_folds, t_test / self.n_folds, scores,
                  scores_total]
        if journal is not None:
            journal.record_config(config_keys, result)
        return result

    def run_grid(self, config_list=None, ledger=None, progress=None):
        """Run many configs (default: the whole grid); returns
        {config_keys: result}. Configs already in ``ledger`` are skipped;
        ``progress(i, total, keys, scores)`` is called after each.

        Every config runs under the dispatch guard: retryable faults are
        retried with backoff, and a config that exhausts its attempts (or
        fails deterministically) is left out of the result and recorded
        in ``self.quarantined``; the sweep goes on. The injection plan
        addresses configs by their index in the canonical grid order."""
        scores = dict(ledger or {})
        if config_list is None:
            config_list = cfg.iter_config_keys()
        todo = [tuple(k) for k in config_list if tuple(k) not in scores]
        guard = rguard.default_guard(plan=rinject.plan_from_env(),
                                     device=self.device)
        self.retries = guard.retries
        for i, keys in enumerate(todo):
            try:
                scores[keys] = guard.call(
                    lambda: self.run_config(keys),
                    config_index=self._index.get(keys),
                    label="/".join(keys))
            except rguard.DispatchAbandoned as e:
                self.quarantined[keys] = {"fault_class": e.fault_class,
                                          "attempts": e.attempts}
            if progress is not None:
                progress(i + 1, len(todo), keys, scores)
        return scores
