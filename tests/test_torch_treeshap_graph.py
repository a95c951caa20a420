"""The port's single-bucket Tree SHAP engine (``ops.treeshap.
graph_inputs``, ``graph_shap``, ``forest_shap_graph``), which the scoring
service runs, against the JAX package's ``_xla_forest_shap`` (with and
without ``sample_chunk``) and against the port's packed
``forest_shap_class0``, on RF, ET and Decision Tree forests at caps 16
and 7. Grade: atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu.ops import treeshap as jshap
from flake16_framework_tpu.ops import trees as jtrees
from flake16_framework_tpu_torch.ops import treeshap as tshap
from flake16_framework_tpu_torch.weights import forest_from_numpy


@pytest.fixture(autouse=True)
def _jax_x64_off():
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    with jax.enable_x64(False):
        yield


# Depth bound 20 >= F, so cap = min(F, depth) = F: 16 for Flake16's
# features and 7 for FlakeFlagger's.
MAX_DEPTH = 20
MODELS = {
    "rf": (jtrees.fit_forest_hist, dict(n_trees=4, bootstrap=True,
                                        random_splits=False,
                                        sqrt_features=True)),
    "et": (jtrees.fit_forest_hist, dict(n_trees=4, bootstrap=False,
                                        random_splits=True,
                                        sqrt_features=True)),
    "dt": (jtrees.fit_forest, dict(n_trees=1, bootstrap=False,
                                   random_splits=False,
                                   sqrt_features=False)),
}


def _forests(model, f, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(160, f).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + 0.5 * rs.randn(160)) > 0.5
    fit, kw = MODELS[model]
    jf = fit(jnp.asarray(x), jnp.asarray(y), jnp.ones(160),
             jax.random.PRNGKey(seed), max_depth=MAX_DEPTH, max_nodes=640,
             **kw)
    tf = forest_from_numpy(jtrees.Forest(*[np.asarray(a) for a in jf]),
                           device="cpu")
    xq = np.random.RandomState(seed + 1).randn(45, f).astype(np.float32)
    return jf, tf, xq


CASES = [pytest.param(m, f, id=f"{m}-cap{f}") for m in MODELS
         for f in (16, 7)]


@pytest.mark.parametrize("model,f", CASES)
def test_graph_inputs_hold_every_row(model, f):
    """One row per (tree, leaf slot), cut to cap = min(F, depth), sorted
    by u, dead rows (not ``valid``) at u = 0 and scale = 0; the live rows
    are the packed engine's, cut to the same cap."""
    _, tf, _ = _forests(model, f, seed=f)
    fid, z, lo, hi, u, scale = tshap.graph_inputs(tf, f)
    n_rows = tf.feature.shape[0] * (tf.feature.shape[1] // 2 + 1)
    assert fid.shape == z.shape == lo.shape == hi.shape == (n_rows, f)
    assert u.shape == scale.shape == (n_rows,)
    assert all(t.is_contiguous() for t in (fid, z, lo, hi, u, scale))
    assert bool((u[1:] >= u[:-1]).all())
    assert bool((scale[u == 0] == 0).all())
    comp = tshap.compact_paths(tf, MAX_DEPTH, f)
    assert int((u > 0).sum()) == int(comp["valid"].sum())
    packed = sum(rows.size for _, rows in tshap.pack_work_items(
        comp["u"].numpy(), comp["valid"].numpy(), n_features=f,
        depth=MAX_DEPTH))
    assert int((u > 0).sum()) == packed


@pytest.mark.parametrize("model,f", CASES)
@pytest.mark.parametrize("chunk", [None, 16], ids=["whole", "chunk16"])
def test_forest_shap_graph_matches_jax(model, f, chunk):
    jf, tf, xq = _forests(model, f, seed=f)
    want = np.asarray(jshap._xla_forest_shap(
        jf, jnp.asarray(xq), depth=int(jf.max_depth), sample_chunk=chunk))
    got = tshap.forest_shap_graph(tf, torch.from_numpy(xq),
                                  sample_chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (45, f)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert np.abs(want).max() > 1e-3


@pytest.mark.parametrize("model,f", CASES)
def test_forest_shap_graph_matches_packed(model, f):
    """The single-bucket engine against the port's packed one on the same
    forest (which trims, packs and launches once a cap bucket)."""
    _, tf, xq = _forests(model, f, seed=f + 3)
    x = torch.from_numpy(xq)
    np.testing.assert_allclose(tshap.forest_shap_graph(tf, x).numpy(),
                               tshap.forest_shap_class0(tf, x).numpy(),
                               atol=1e-6)


def test_graph_shap_is_one_launch_of_the_unit(monkeypatch):
    """``graph_shap`` calls the unit wrapper once, on the prepared rows,
    whatever the number of cap buckets the packed engine would use."""
    _, tf, xq = _forests("rf", 16, seed=4)
    inputs = tshap.graph_inputs(tf, 16)
    calls = []
    real = tshap.unit_shap
    monkeypatch.setattr(tshap, "unit_shap",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    phi = tshap.graph_shap(inputs, tf.feature.shape[0], torch.from_numpy(xq))
    assert calls == [inputs[0].shape] and phi.shape == (45, 16)
