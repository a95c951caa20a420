"""The per-config 10-fold CV pipeline: preprocess -> bin edges (once per
config) -> per fold: resample -> fit -> predict -> per-project confusion.

Keys follow the JAX package exactly: the config key is
``fold_in(PRNGKey(SEED), config_index)`` over the canonical grid order;
fold keys are ``split(config_key, n_folds)``; each fold key splits into the
resampler's key and the forest's key. Folds run one after another; each
fold's trees grow as one tree batch.
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
from flake16_framework_tpu_torch.parallel.folds import fold_masks

N_FOLDS = 10
SEED = 0  # the config keys' root seed, as the reference's


def require_hist_model(config_keys):
    """Raise for a config this slice cannot run: single-tree Decision Tree
    configs need the exact sort-based grower, which the port lacks."""
    if cfg.MODELS[config_keys[4]].n_trees <= 1:
        raise NotImplementedError(
            f"config {'/'.join(config_keys)}: Decision Tree configs need "
            f"the exact sort-based grower, the next slice of the port")


class SweepEngine:
    """Host driver of the grid on one device: ``run_config`` returns the
    reference ``scores.pkl`` value ``[t_train, t_test, scores,
    scores_total]``; ``run_grid`` runs many configs."""

    def __init__(self, features, labels_raw, projects, project_names,
                 project_ids, *, max_depth=48, tree_overrides=None,
                 device=None):
        self.device = resolve(device)
        self.features = np.asarray(features, dtype=np.float32)
        self.labels_raw = torch.as_tensor(np.asarray(labels_raw, np.int32),
                                          device=self.device)
        self.projects = projects
        self.project_names = project_names
        self.project_ids = torch.as_tensor(
            np.asarray(project_ids, np.int32), device=self.device)
        self.max_depth = max_depth
        self.tree_overrides = tree_overrides or {}
        labels = np.asarray(labels_raw)
        self._masks = {
            fl_name: tuple(torch.as_tensor(m, device=self.device)
                           for m in fold_masks(labels == fl, N_FOLDS, 0))
            for fl_name, fl in cfg.FLAKY_TYPES.items()
        }
        self._index = {k: i for i, k in enumerate(cfg.iter_config_keys())}

    def _spec(self, model_name):
        spec = cfg.MODELS[model_name]
        if model_name in self.tree_overrides:
            spec = type(spec)(spec.name, self.tree_overrides[model_name],
                              spec.bootstrap, spec.random_splits,
                              spec.sqrt_features)
        return spec

    def run_config(self, config_keys):
        """One config's 10-fold CV; returns
        [t_train, t_test, scores, scores_total] (per-fold mean walls)."""
        config_keys = tuple(config_keys)
        require_hist_model(config_keys)
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
        edges = trees.quantile_edges(xp)
        key = rng.fold_in(rng.prng_key(SEED, dev),
                          self._index[config_keys])
        fold_keys = rng.split(key, N_FOLDS)
        forests = []
        for f in range(N_FOLDS):
            kb, kf = rng.split(fold_keys[f]).unbind(0)
            xs, ys, ws = resample(xp, y, train_mask[f], bal_code, kb, cap)
            forests.append(trees.fit_forest_hist(
                xs, ys, ws, kf, n_trees=spec.n_trees,
                bootstrap=spec.bootstrap, random_splits=spec.random_splits,
                sqrt_features=spec.sqrt_features, max_depth=self.max_depth,
                max_nodes=2 * cap, edges=edges))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_train = time.time() - t0

        t0 = time.time()
        preds = trees.predict_batch(forests, xp)
        counts = confusion_by_project(y, preds, test_mask, self.project_ids,
                                      len(self.project_names)).cpu().numpy()
        t_test = time.time() - t0
        scores, scores_total = format_scores(counts, self.project_names,
                                             self.projects)
        return [t_train / N_FOLDS, t_test / N_FOLDS, scores,
                scores_total]

    def run_grid(self, config_list=None, ledger=None, progress=None):
        """Run many configs (default: the whole grid); returns
        {config_keys: result}. Configs already in ``ledger`` are skipped;
        ``progress(i, total, keys, scores)`` is called after each."""
        scores = dict(ledger or {})
        if config_list is None:
            config_list = cfg.iter_config_keys()
        todo = [tuple(k) for k in config_list if tuple(k) not in scores]
        for keys in todo:
            require_hist_model(keys)
        for i, keys in enumerate(todo):
            scores[keys] = self.run_config(keys)
            if progress is not None:
                progress(i + 1, len(todo), keys, scores)
        return scores
