"""The reference's two entries, straightforward loops over the frozen
math:

- ``config_counts``: one config of the study's sweep, fold after fold
  (preprocess the full matrix, bin edges once a config on the histogram
  grower, then per fold: resample, fit, predict, count), as the port's
  staged path does; each fold's counts equal the fold-batched path's.
- ``fit_served`` / ``served_answers``: a served model fitted on the
  balanced full set (the SHAP stage's fit) under ``prng_key(seed)``, and
  its predict probabilities and class-0 SHAP values for raw feature rows.

``lowp=True`` (``config_counts``, ``served_answers``) is the control: the
same computation with the preprocessed features rounded to bfloat16, the
nearest precision below the float32 the configurations state.
"""

from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

from port_bench.reference import grid, rng, trees, treeshap
from port_bench.reference.folds import fold_masks
from port_bench.reference.metrics import confusion_by_project
from port_bench.reference.preprocess import fit_preprocess, transform
from port_bench.reference.resample import resample

N_FOLDS = 10


@contextmanager
def full_f32():
    """float32 matmuls without TF32 (the program pins the same), restored
    after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _lowp(x, lowp):
    return x.to(torch.bfloat16).to(torch.float32) if lowp else x


def _grow(xs, ys, ws, key, spec, edges, max_depth, max_nodes):
    """An ensemble on the histogram grower, the Decision Tree (which
    takes no draws) on the exact grower."""
    n_trees, bootstrap, random_splits, sqrt_features = spec
    if trees.hist_tier_default(n_trees):
        return trees.fit_forest_hist(
            xs, ys, ws, key, edges=edges, n_trees=n_trees,
            bootstrap=bootstrap, random_splits=random_splits,
            sqrt_features=sqrt_features, max_depth=max_depth,
            max_nodes=max_nodes)
    if spec != grid.MODELS["Decision Tree"]:
        raise ValueError(f"the exact grower fits the Decision Tree, not "
                         f"{spec}")
    return trees.fit_tree_exact(xs, ys, ws, max_depth=max_depth,
                                max_nodes=max_nodes)


def config_counts(keys, feats, labels, project_ids, n_projects, *, seed,
                  device, max_depth=48, n_trees=None, lowp=False):
    """Per-project (FP, FN, TP) int64 [P, 3] of one config's 10-fold CV,
    summed over the folds. ``n_trees`` overrides the ensembles' 100."""
    fl, cols, prep, bal, spec = grid.resolve(keys)
    if n_trees is not None and spec[0] > 1:
        spec = (n_trees,) + spec[1:]
    with full_f32():
        x = torch.as_tensor(np.asarray(feats, np.float32)[:, list(cols)],
                            device=device)
        lab = np.asarray(labels) == fl
        y = torch.as_tensor(lab, device=device)
        pids = torch.as_tensor(np.asarray(project_ids, np.int32),
                               device=device)
        mu, wmat = fit_preprocess(x, prep)
        xp = _lowp(transform(x, mu, wmat), lowp)
        cap = 2 * x.shape[0]
        edges = trees.quantile_edges(xp) if trees.hist_tier_default(
            spec[0]) else None
        key = rng.fold_in(rng.prng_key(seed, device), grid.config_index(keys))
        fold_keys = rng.split(key, N_FOLDS)
        train, test = (torch.as_tensor(m, device=device)
                       for m in fold_masks(lab, N_FOLDS, 0))
        total = torch.zeros((n_projects, 3), dtype=torch.int64,
                            device=device)
        for f in range(N_FOLDS):
            kb, kf = rng.split(fold_keys[f]).unbind(0)
            xs, ys, ws = resample(xp, y, train[f], bal, kb, cap)
            forest = _grow(xs, ys, ws, kf, spec, edges, max_depth, 2 * cap)
            pred = trees.predict(forest, xp)
            total += confusion_by_project(y, pred[None], test[f:f + 1], pids,
                                          n_projects)
        return total.cpu().numpy()


class Served(NamedTuple):
    """A served model as the reference fits it."""

    keys: tuple
    cols: tuple
    mu: torch.Tensor
    wmat: torch.Tensor
    forest: trees.Forest


def fit_served(keys, feats, labels, *, seed, device, max_depth=48,
               n_trees=None):
    fl, cols, prep, bal, spec = grid.resolve(keys)
    if n_trees is not None and spec[0] > 1:
        spec = (n_trees,) + spec[1:]
    with full_f32():
        x = torch.as_tensor(np.asarray(feats, np.float32)[:, list(cols)],
                            device=device)
        y = torch.as_tensor(np.asarray(labels) == fl, device=device)
        n = x.shape[0]
        mu, wmat = fit_preprocess(x, prep)
        xp = transform(x, mu, wmat)
        kb, kf = rng.split(rng.prng_key(seed, device)).unbind(0)
        xs, ys, ws = resample(xp, y, torch.ones(n, device=device), bal, kb,
                              2 * n)
        forest = _grow(xs, ys, ws, kf, spec, None, max_depth, 4 * n)
        # The served artifact's node axis: max(n_nodes) rounded up to 128
        # slots (at least 128), as a registered model is trimmed.
        m = forest.feature.shape[-1]
        used = int(forest.n_nodes.max())
        forest = trees.trim_nodes(forest, min(m, max(128, -(-used // 128)
                                                     * 128)))
    return Served(tuple(keys), tuple(cols), mu, wmat, forest)


def served_answers(model, rows, kind, *, lowp=False):
    """The answers to raw feature rows [S, 16] (numpy): predict gives the
    soft vote [S, 2], shap the class-0 values [S, F'] (numpy f32)."""
    dev = model.mu.device
    with full_f32():
        x = torch.as_tensor(np.asarray(rows, np.float32)[:, list(model.cols)],
                            device=dev)
        xt = _lowp(transform(x, model.mu, model.wmat), lowp)
        if kind == "predict":
            out = trees.predict_proba(model.forest, xt)
        else:
            out = treeshap.forest_shap(model.forest, xt)
    return out.cpu().numpy()
