"""The fold-batched fits of the port (``ops/trees.py``: ``fit_folds_hist``,
``fit_folds``, ``predict_batch``; ``ops/metrics.py``: ``confusion_by_fold``)
against the one-fold fits they batch, and through those against the JAX
package's. Grade: bitwise for every Forest field of every fold, whatever
the tree batches, and for predictions and counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu.ops import trees as jtrees
from flake16_framework_tpu_torch import rng
from flake16_framework_tpu_torch.ops import trees as ttrees
from flake16_framework_tpu_torch.ops.metrics import (
    confusion_by_fold, confusion_by_project,
)

FIELDS = ("feature", "threshold", "left", "right", "value", "n_nodes")
N_FOLDS = 3

RF = dict(bootstrap=True, random_splits=False, sqrt_features=True)
ET = dict(bootstrap=False, random_splits=True, sqrt_features=True)
DT = dict(bootstrap=False, random_splits=False, sqrt_features=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs several
    workers on the machine's cores, and a fold batch's tensors pass the
    size above which torch's CPU kernels split across threads, whose
    barriers then wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_x64_off():
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    with jax.enable_x64(False):
        yield


def _folds(n=240, f=16, seed=0):
    """G folds' train sets, each with its own rows, ties, and rows of
    weight 0."""
    rs = np.random.RandomState(seed)
    x = rs.randn(N_FOLDS, n, f).astype(np.float32)
    x[..., 5] = np.round(x[..., 5])
    y = (x[..., 0] - x[..., 3] + 0.5 * rs.randn(N_FOLDS, n)) > 0.5
    w = (rs.rand(N_FOLDS, n) > 0.15).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w)


def _fold(forest, g):
    return ttrees.Forest(*(f[g] for f in forest[:-1]), forest.max_depth)


def _assert_equal(got, want):
    for fld in FIELDS:
        a, b = getattr(got, fld), getattr(want, fld)
        assert a.dtype == b.dtype and a.shape == b.shape, fld
        assert torch.equal(a, b), fld


# (tree_chunk, fold_chunk): one batch, trees split, folds split, both
BOUNDS = [(None, None), (2, None), (None, 2), (3, 1)]


@pytest.mark.parametrize("bounds", BOUNDS, ids=lambda b: f"{b[0]}-{b[1]}")
@pytest.mark.parametrize("model", ["rf", "et"])
def test_hist_folds_bitwise_vs_one_fold(model, bounds):
    x, y, w = _folds(seed=1)
    keys = rng.split(rng.prng_key(7), N_FOLDS)
    edges = ttrees.quantile_edges(x.reshape(-1, x.shape[-1]))
    kw = dict(n_trees=4, max_depth=24, **{"rf": RF, "et": ET}[model])
    got = ttrees.fit_folds_hist(x, y, w, keys, edges=edges,
                                tree_chunk=bounds[0], fold_chunk=bounds[1],
                                **kw)
    assert got.feature.shape[:2] == (N_FOLDS, 4)
    for g in range(N_FOLDS):
        _assert_equal(_fold(got, g), ttrees.fit_forest_hist(
            x[g], y[g], w[g], keys[g], edges=edges, **kw))


@pytest.mark.parametrize("model", ["rf", "et"])
def test_hist_folds_equal_jax_forests(model):
    """Each fold of a batch equals the JAX package's ``fit_forest_hist``
    on that fold (given the shared edges), bit for bit."""
    x, y, w = _folds(seed=2)
    keys = rng.split(rng.prng_key(3), N_FOLDS)
    edges = ttrees.quantile_edges(x[0])
    kw = dict(n_trees=3, max_depth=24, **{"rf": RF, "et": ET}[model])
    got = ttrees.fit_folds_hist(x, y, w, keys, edges=edges, **kw)
    jkeys = np.asarray(keys, np.uint32)
    for g in range(N_FOLDS):
        want = jtrees.fit_forest_hist(
            jnp.asarray(x[g].numpy()), jnp.asarray(y[g].numpy()),
            jnp.asarray(w[g].numpy()), jnp.asarray(jkeys[g]),
            edges=jnp.asarray(edges.numpy()), **kw)
        for fld in FIELDS:
            assert getattr(got, fld)[g].numpy().tobytes() == \
                np.asarray(getattr(want, fld)).tobytes(), (g, fld)


EXACT_CASES = [
    pytest.param(DT, 1, {}, (None, None), id="dt"),
    pytest.param(DT, 1, {}, (None, 2), id="dt-folds2"),
    pytest.param(DT, 1, dict(max_nodes=15), (None, None), id="dt-capacity"),
    pytest.param(DT, 1, dict(max_depth=1), (None, None), id="dt-depth1"),
    pytest.param(RF, 3, {}, (2, 2), id="rf-exact-tier"),
    pytest.param(ET, 3, {}, (None, None), id="et-exact-tier"),
    pytest.param(ET, 3, dict(max_nodes=15), (1, None), id="et-capacity"),
]


@pytest.mark.parametrize("model,n_trees,limits,bounds", EXACT_CASES)
def test_exact_folds_bitwise_vs_one_fold(model, n_trees, limits, bounds):
    """The exact grower's fold batch: every tree of every fold equals
    ``fit_forest``'s with each tree grown alone (``tree_chunk=1``, the
    one-tree level), also where some trees stop growing levels before
    others (depth, capacity, purity)."""
    x, y, w = _folds(seed=3)
    keys = rng.split(rng.prng_key(5), N_FOLDS)
    kw = dict(dict(n_trees=n_trees, max_depth=24, **model), **limits)
    got = ttrees.fit_folds(x, y, w, keys, tree_chunk=bounds[0],
                           fold_chunk=bounds[1], **kw)
    n_nodes = []
    for g in range(N_FOLDS):
        want = ttrees.fit_forest(x[g], y[g], w[g], keys[g], tree_chunk=1,
                                 **kw)
        _assert_equal(_fold(got, g), want)
        n_nodes += want.n_nodes.tolist()
    if not limits:
        assert len(set(n_nodes)) > 1        # trees of different sizes


def test_exact_folds_equal_jax_forests():
    x, y, w = _folds(seed=4)
    keys = rng.split(rng.prng_key(9), N_FOLDS)
    kw = dict(n_trees=1, max_depth=48, **DT)
    got = ttrees.fit_folds(x, y, w, keys, **kw)
    jkeys = np.asarray(keys, np.uint32)
    for g in range(N_FOLDS):
        want = jtrees.fit_forest(
            jnp.asarray(x[g].numpy()), jnp.asarray(y[g].numpy()),
            jnp.asarray(w[g].numpy()), jnp.asarray(jkeys[g]), **kw)
        for fld in FIELDS:
            assert getattr(got, fld)[g].numpy().tobytes() == \
                np.asarray(getattr(want, fld)).tobytes(), (g, fld)


def test_predict_and_count_folds_as_one_batch():
    """``predict_batch`` of a fold batch equals ``predict`` of each fold's
    forest, and ``confusion_by_fold`` each fold's
    ``confusion_by_project``."""
    x, y, w = _folds(seed=5)
    keys = rng.split(rng.prng_key(1), N_FOLDS)
    edges = ttrees.quantile_edges(x[0])
    forest = ttrees.fit_folds_hist(x, y, w, keys, edges=edges, n_trees=4,
                                   max_depth=24, **RF)
    rs = np.random.RandomState(6)
    xq = torch.from_numpy(rs.randn(150, 16).astype(np.float32))
    preds = ttrees.predict_batch(forest, xq)
    assert preds.shape == (N_FOLDS, 150) and preds.dtype == torch.bool
    for g in range(N_FOLDS):
        assert torch.equal(preds[g], ttrees.predict(_fold(forest, g), xq))
    labels = torch.from_numpy(rs.rand(150) < 0.3)
    test_mask = torch.from_numpy((rs.rand(N_FOLDS, 150) < 0.4)
                                 .astype(np.float32))
    pids = torch.from_numpy(rs.randint(0, 5, size=150).astype(np.int32))
    counts = confusion_by_fold(labels, preds, test_mask, pids, 5)
    assert counts.dtype == torch.int32 and counts.shape == (N_FOLDS, 5, 3)
    for g in range(N_FOLDS):
        assert torch.equal(counts[g], confusion_by_project(
            labels, preds[g][None], test_mask[g:g + 1], pids, 5))
    assert int(counts.sum()) > 0
