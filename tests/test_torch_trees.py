"""The port's histogram grower and predict against the JAX package's
``fit_forest_hist`` and ``predict`` on the same inputs and keys. Grade:
bitwise for every Forest field (RF and ET), for the bin edges, the
bootstrap counts and predict_proba."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu.ops import trees as jtrees
from flake16_framework_tpu_torch import rng
from flake16_framework_tpu_torch.ops import trees as ttrees
from flake16_framework_tpu_torch.weights import forest_from_numpy

FIELDS = ("feature", "threshold", "left", "right", "value", "n_nodes")


@pytest.fixture(autouse=True)
def _jax_x64_off():
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    with jax.enable_x64(False):
        yield


def _data(n=240, f=16, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, f).astype(np.float32)
    x[:, 5] = np.round(x[:, 5])                  # ties and constant nodes
    y = (x[:, 0] - x[:, 3] + 0.5 * rs.randn(n)) > 1.0
    w = (rs.rand(n) > 0.15).astype(np.float32)   # a fold's train mask
    return x, y, w


def _assert_forest_equal(got, want):
    for fld in FIELDS:
        a = getattr(got, fld).numpy()
        b = np.asarray(getattr(want, fld))
        assert a.dtype == b.dtype and a.shape == b.shape, fld
        assert a.tobytes() == b.tobytes(), fld


def _fit_both(x, y, w, seed, **kw):
    want = jtrees.fit_forest_hist(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(w), jax.random.PRNGKey(seed),
                                  **kw)
    got = ttrees.fit_forest_hist(torch.from_numpy(x), torch.from_numpy(y),
                                 torch.from_numpy(w), rng.prng_key(seed), **kw)
    return got, want


MODELS = {"rf": dict(bootstrap=True, random_splits=False),
          "et": dict(bootstrap=False, random_splits=True)}


@pytest.mark.parametrize("model", ["rf", "et"])
@pytest.mark.parametrize("seed", [0, 1])
def test_forest_bitwise(model, seed):
    x, y, w = _data(seed=seed)
    got, want = _fit_both(x, y, w, seed, n_trees=3, sqrt_features=True,
                          max_depth=8, **MODELS[model])
    _assert_forest_equal(got, want)
    assert int(got.n_nodes.min()) > 3


@pytest.mark.parametrize("model", ["rf", "et"])
def test_forest_bitwise_with_shared_edges_and_capacity(model):
    # as the sweep calls it: edges from the full matrix, node capacity
    # 2 * cap, a shallow depth bound that stops growth
    x, y, w = _data(n=200, seed=4)
    edges = jtrees.quantile_edges(jnp.asarray(x))
    want = jtrees.fit_forest_hist(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
        jax.random.PRNGKey(9), n_trees=2, sqrt_features=True, max_depth=4,
        max_nodes=40, edges=edges, **MODELS[model])
    got = ttrees.fit_forest_hist(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
        rng.prng_key(9), n_trees=2, sqrt_features=True, max_depth=4,
        max_nodes=40, edges=torch.from_numpy(np.array(edges)),
        **MODELS[model])
    _assert_forest_equal(got, want)


def test_width_and_chunk_are_results_neutral(monkeypatch):
    # neither the BFS window width nor which trees share a batch changes
    # a tree: grow a 3-tree batch at two widths, then its trees in batches
    # of 2 and 1 at a third, and compare tree by tree
    x, y, w = _data(seed=2)
    kw = dict(n_trees=3, bootstrap=True, random_splits=False,
              sqrt_features=True, max_depth=8)
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
            rng.prng_key(3))
    monkeypatch.setitem(ttrees.NODE_BATCH, "cpu", 5)
    a = ttrees.fit_forest_hist(*args, **kw)
    monkeypatch.setitem(ttrees.NODE_BATCH, "cpu", 32)
    b = ttrees.fit_forest_hist(*args, **kw)
    for fld in FIELDS:
        assert torch.equal(getattr(a, fld), getattr(b, fld)), fld

    xt = torch.from_numpy(x)
    edges = ttrees.quantile_edges(xt)
    bin_t = ttrees.bin_indices(xt, edges).T.to(torch.uint8).contiguous()
    kk = rng.split(rng.split(rng.prng_key(3), 3))
    wt = ttrees.bootstrap_weights(torch.from_numpy(w), kk[:, 0])
    grow = dict(random_splits=False, max_features=4, max_depth=8,
                max_nodes=2 * x.shape[0], node_batch=16)
    y01 = torch.from_numpy(y).float()
    parts = [ttrees._grow_trees(xt[None], bin_t[None], edges, y01[None],
                                wt[s], kk[s, 1], **grow)
             for s in (slice(0, 2), slice(2, 3))]
    for fld, got in zip(FIELDS, (torch.cat(f, 0) for f in zip(*parts))):
        assert torch.equal(getattr(a, fld), got), fld


def test_edges_bins_and_bootstrap_bitwise():
    x, _, w = _data(seed=5)
    je = jtrees.quantile_edges(jnp.asarray(x))
    te = ttrees.quantile_edges(torch.from_numpy(x))
    assert te.numpy().tobytes() == np.asarray(je).tobytes()
    _, jbin = jtrees._bin_onehot(jnp.asarray(x), je)
    np.testing.assert_array_equal(ttrees.bin_indices(torch.from_numpy(x), te),
                                  np.asarray(jbin))
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    want = jax.vmap(lambda k: jtrees._bootstrap_weights(jnp.asarray(w), k))(
        keys)
    got = ttrees.bootstrap_weights(torch.from_numpy(w),
                                   torch.from_numpy(np.asarray(keys, np.int64)))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("model", ["rf", "et"])
def test_predict_on_a_jax_forest(model):
    x, y, w = _data(seed=6)
    jf = jtrees.fit_forest_hist(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(w), jax.random.PRNGKey(2),
                                n_trees=4, sqrt_features=True, max_depth=8,
                                **MODELS[model])
    tf = forest_from_numpy(jtrees.Forest(*[np.asarray(a) for a in jf]),
                           device="cpu")
    xq = np.random.RandomState(7).randn(90, 16).astype(np.float32)
    xq = np.concatenate([x[:30], xq])
    want = np.asarray(jtrees.predict_proba(jf, jnp.asarray(xq)))
    got = ttrees.predict_proba(tf, torch.from_numpy(xq)).numpy()
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(
        ttrees.predict(tf, torch.from_numpy(xq)).numpy(),
        np.asarray(jtrees.predict(jf, jnp.asarray(xq))))
    pair = ttrees.Forest(*(torch.stack([a, a]) for a in tf[:-1]),
                         tf.max_depth)
    np.testing.assert_array_equal(
        ttrees.predict_batch(pair, torch.from_numpy(xq)).numpy(),
        np.asarray(jtrees.predict_batch(
            jax.tree.map(lambda a: jnp.stack([a, a]), jf), jnp.asarray(xq))))


def test_et_threshold_draw_rounds_once():
    """The JAX package's Extra Trees draw ``vmin + u * (vmax - vmin)`` is
    one fused multiply-add on the CPU (XLA contracts it). Tree 18 of this
    25-tree fit has a node (1956) whose draw lands on the other side of a
    bin edge when the product and the sum are rounded apart, so the tree
    differs unless the port's draw rounds once (``_fma``)."""
    rs = np.random.RandomState(104)
    x = rs.randn(4000, 16).astype(np.float32)
    y = (x[:, 0] - x[:, 3] + 0.5 * rs.randn(4000)) > 0.5
    w = (rs.rand(4000) > 0.15).astype(np.float32)
    tree_key = jax.random.split(jax.random.PRNGKey(104), 25)[18:19]
    want = jtrees.fit_forest_hist(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), None, n_trees=1,
        bootstrap=False, random_splits=True, sqrt_features=True,
        max_depth=48, tree_keys=tree_key)
    xt = torch.from_numpy(x)
    edges = ttrees.quantile_edges(xt)
    bin_t = ttrees.bin_indices(xt, edges).T.to(torch.uint8).contiguous()
    kg = rng.split(torch.from_numpy(np.asarray(tree_key, np.int64)))[:, 1]

    fields = ttrees._grow_trees(
        xt[None], bin_t[None], edges, torch.from_numpy(y).float()[None],
        torch.from_numpy(w)[None], kg, random_splits=True, max_features=4,
        max_depth=48, max_nodes=8000, node_batch=128)
    _assert_forest_equal(ttrees.Forest(*fields, 48), want)
