"""The verbs. ``scores``: the 10-fold CV sweep over the grid, written as
the reference-schema ``scores.pkl`` ({config_keys: [t_train, t_test,
scores, scores_total]}); a partial ``scores.pkl`` is reloaded and its
configs are skipped. ``shap``: Tree SHAP values of the two paper configs,
written as ``shap.pkl`` (a list of two float32 [N, F] arrays in
``config.SHAP_CONFIGS`` order)."""

import os
import pickle
import sys
import time

import numpy as np
import torch

from flake16_framework_tpu_torch import config as cfg, rng
from flake16_framework_tpu_torch.constants import (
    LOPO_SCORES_FILE, SCORES_FILE, SHAP_FILE, TESTS_FILE,
)
from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
from flake16_framework_tpu_torch.device import resolve
from flake16_framework_tpu_torch.ops import trees, treeshap
from flake16_framework_tpu_torch.ops.preprocess import fit_preprocess, transform
from flake16_framework_tpu_torch.ops.resample import resample
from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
from flake16_framework_tpu_torch.utils.synth import atomic_write_bytes

CHECKPOINT_EVERY = 12  # configs between partial ``scores.pkl`` dumps


def _load_ledger(out_file):
    if not os.path.exists(out_file):
        return {}
    with open(out_file, "rb") as fd:
        ledger = pickle.load(fd)
    return {k: v for k, v in ledger.items()
            if isinstance(v, (list, tuple)) and len(v) == 4}


def _dump(obj, path):
    atomic_write_bytes(path, pickle.dumps(obj))


def write_scores(tests_file=TESTS_FILE, out_file=None, *,
                 max_depth=48, tree_overrides=None, configs=None,
                 progress_out=sys.stdout, cv="stratified", device=None):
    """Run the sweep over ``configs`` (key tuples, as the JAX package's
    ``write_scores`` takes them; default the whole grid) and pickle the
    scores. ``cv="lopo"`` runs leave-one-project-out CV; the default
    ``out_file`` follows the scheme (``scores.pkl`` or
    ``scores-lopo.pkl``), so a LOPO run never resumes from a stratified
    ledger. Runs on ``cuda`` unless ``device`` says otherwise."""
    if out_file is None:
        out_file = SCORES_FILE if cv == "stratified" else LOPO_SCORES_FILE
    device = resolve(device)
    feats, labels, projects, names, pids = tests_to_arrays(
        load_tests(tests_file))
    engine = SweepEngine(feats, labels, projects, names, pids,
                         max_depth=max_depth, tree_overrides=tree_overrides,
                         cv=cv, device=device)
    ledger = _load_ledger(out_file)
    t0 = time.time()

    def progress(i, total, keys, live_scores):
        progress_out.write(
            f"[{i}/{total}] {', '.join(keys)} ({time.time() - t0:.1f}s "
            f"elapsed)\n")
        if i % CHECKPOINT_EVERY == 0:
            _dump(live_scores, out_file)

    scores = engine.run_grid(configs, ledger=ledger, progress=progress)
    _dump(scores, out_file)
    return scores


def fit_shap_forest(config_keys, feats, labels_raw, *, max_depth=48,
                    tree_overrides=None, device=None):
    """The SHAP stage's fit (reference get_shap): preprocess the full
    matrix, balance it, fit the config's forest on the balanced set with
    node capacity 4N. Keys as the JAX package's staged path:
    ``split(PRNGKey(0))`` into the resampler's and the forest's.
    Returns (xp [N, F'] the preprocessed samples, forest)."""
    dev = resolve(device)
    fl, cols, prep, bal, spec = cfg.resolve_config(config_keys)
    if tree_overrides and spec.name in tree_overrides:
        spec = type(spec)(spec.name, tree_overrides[spec.name],
                          spec.bootstrap, spec.random_splits,
                          spec.sqrt_features)
    x = torch.as_tensor(np.asarray(feats[:, list(cols)], dtype=np.float32),
                        device=dev)
    y = torch.as_tensor(np.asarray(labels_raw) == fl, device=dev)
    n = x.shape[0]
    mu, wmat = fit_preprocess(x, prep)
    xp = transform(x, mu, wmat)
    kb, kf = rng.split(rng.prng_key(0, dev)).unbind(0)
    xs, ys, ws = resample(xp, y, torch.ones(n, dtype=torch.float32,
                                            device=dev), bal, kb, 2 * n)
    fit = trees.fit_forest_hist if trees.hist_tier_default(spec.n_trees) \
        else trees.fit_forest
    forest = fit(xs, ys, ws, kf, n_trees=spec.n_trees,
                 bootstrap=spec.bootstrap, random_splits=spec.random_splits,
                 sqrt_features=spec.sqrt_features, max_depth=max_depth,
                 max_nodes=4 * n)
    return xp, forest


def shap_for_config(config_keys, feats, labels_raw, *, max_depth=48,
                    tree_overrides=None, device=None):
    """One SHAP config: fit (``fit_shap_forest``), then explain every
    original sample. Returns {"values": class-0 SHAP values [N, F'] f32
    numpy, "forest", "x": the explained samples, "fit_s", "explain_s":
    the two stages' walls in seconds}."""
    dev = resolve(device)
    t0 = time.time()
    xp, forest = fit_shap_forest(config_keys, feats, labels_raw,
                                 max_depth=max_depth,
                                 tree_overrides=tree_overrides, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fit_s = time.time() - t0
    t0 = time.time()
    values = treeshap.forest_shap_class0(forest, xp).cpu().numpy()
    return {"values": values, "forest": forest, "x": xp, "fit_s": fit_s,
            "explain_s": time.time() - t0}


def write_shap(tests_file=TESTS_FILE, out_file=SHAP_FILE, *, max_depth=48,
               tree_overrides=None, device=None):
    """The two paper configs (``config.SHAP_CONFIGS``): pickles their
    values to ``out_file`` and returns the per-config results of
    ``shap_for_config``. Runs on ``cuda`` unless ``device`` says
    otherwise."""
    device = resolve(device)
    feats, labels, _, _, _ = tests_to_arrays(load_tests(tests_file))
    results = [shap_for_config(keys, feats, labels, max_depth=max_depth,
                               tree_overrides=tree_overrides, device=device)
               for keys in cfg.SHAP_CONFIGS]
    _dump([r["values"] for r in results], out_file)
    return results
