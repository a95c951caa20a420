"""The port's EXTEND/UNWIND vectors and its whole-grid explainers against
the JAX package's on the same inputs and forests (JAX forests carried
across by ``weights.forest_from_numpy``). Grades: the vectors bitwise
(the same expressions in the same order; no multiply-add that XLA:CPU
could contract into one rounding); interventional, interaction and
path-dependent values at atol 1e-6; interaction matrices exactly
symmetric; local accuracy at atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu.ops import trees as jtrees
from flake16_framework_tpu.ops import treeshap as jshap
from flake16_framework_tpu_torch.ops import trees as ttrees
from flake16_framework_tpu_torch.ops import treeshap as tshap
from flake16_framework_tpu_torch.weights import forest_from_numpy


@pytest.fixture(autouse=True)
def _jax_x64_off():
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    with jax.enable_x64(False):
        yield


def _path_lanes(r=6, s=5, k=7, seed=0):
    """Random EXTEND inputs [R, S, K]: present a per-row prefix (u in
    [0, K], so dead and one-slot rows occur), z in (0, 1], o in {0, 1}
    with whole rows of zeros and of ones."""
    rs = np.random.RandomState(seed)
    u = rs.randint(0, k + 1, size=r)
    u[:2] = (0, 1)
    present = np.broadcast_to((np.arange(k) < u[:, None])[:, None, :],
                              (r, s, k)).copy()
    z = np.broadcast_to(rs.uniform(0.05, 1.0, (r, 1, k)), (r, s, k))
    o = (rs.rand(r, s, k) < 0.5).astype(np.float32)
    o[:, 0] = 0.0
    o[:, 1] = 1.0
    return present, z.astype(np.float32), o * present


def _bitwise(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.numpy().tobytes() == want.tobytes()


def test_extend_and_unwind_vectors_match_jax():
    k = 7
    present, z, o = _path_lanes(r=12, s=9, k=k)
    w_j, l_j = jshap._extend_all(jnp.asarray(present), jnp.asarray(z),
                                 jnp.asarray(o), k)
    tp, tz, to = (torch.from_numpy(a) for a in (present, z, o))
    w, l = tshap.extend_all(tp, tz, to, k)
    assert w.shape == (12, 9, k + 2)
    _bitwise(w, w_j)
    _bitwise(l, l_j)
    for i in range(k):
        zi, oi = tz[..., i], to[..., i]
        args = [jnp.asarray(a.numpy()) for a in (w, l, zi, oi)]
        live = present[..., i]
        got = tshap.unwound_sum(w, l, zi, oi)
        _bitwise(got[live], np.asarray(jshap._unwound_sum(*args))[live])
        got_m = tshap.unwind_weights(w, l, zi, oi)
        _bitwise(got_m[live], np.asarray(jshap._unwind_weights(*args))[live])
        # the unwound sum is the sum of the unwound vector
        np.testing.assert_allclose(got_m.sum(-1)[live].numpy(),
                                   got[live].numpy(), rtol=1e-5, atol=1e-7)


def test_vectors_broadcast_over_slots_and_pairs():
    """One call over a slot axis (and a pair axis) equals a call a slot,
    bitwise: the port's form of the JAX package's vmaps."""
    k = 6
    present, z, o = (torch.from_numpy(a) for a in _path_lanes(k=k, seed=3))
    w, l = tshap.extend_all(present, z, o, k)
    zk, ok = z.permute(2, 0, 1), o.permute(2, 0, 1)
    totals = tshap.unwound_sum(w, l, zk, ok)
    mj = tshap.unwind_weights(w, l, zk, ok)
    pairs = tshap.unwound_sum(mj[:, None], l - 1.0, zk[None], ok[None])
    for i in range(k):
        assert torch.equal(totals[i], tshap.unwound_sum(w, l, zk[i], ok[i]))
        assert torch.equal(mj[i], tshap.unwind_weights(w, l, zk[i], ok[i]))
        for j in range(k):
            assert torch.equal(pairs[j, i], tshap.unwound_sum(
                mj[j], l - 1.0, zk[i], ok[i]))


def test_interventional_tables_match_jax():
    for f in (7, 16):
        wx, wb = tshap.interventional_tables(f)
        jwx, jwb = jshap._interventional_tables(f)
        assert wx.dtype == torch.float32
        assert wx.numpy().tobytes() == np.asarray(jwx).tobytes()
        assert wb.numpy().tobytes() == np.asarray(jwb).tobytes()


MODELS = {"rf": dict(bootstrap=True, random_splits=False),
          "et": dict(bootstrap=False, random_splits=True)}


def _forests(model, f, seed=0, n_trees=4, max_depth=8):
    rs = np.random.RandomState(seed)
    x = rs.randn(160, f).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + 0.5 * rs.randn(160)) > 0.5
    jf = jtrees.fit_forest_hist(jnp.asarray(x), jnp.asarray(y),
                                jnp.ones(x.shape[0]), jax.random.PRNGKey(seed),
                                n_trees=n_trees, sqrt_features=True,
                                max_depth=max_depth, max_nodes=4 * x.shape[0],
                                **MODELS[model])
    tf = forest_from_numpy(jtrees.Forest(*[np.asarray(a) for a in jf]),
                           device="cpu")
    xq = np.random.RandomState(seed + 1).randn(23, f).astype(np.float32)
    return jf, tf, xq


CASES = [("rf", 16), ("et", 16), ("et", 7), ("rf", 5)]


@pytest.mark.parametrize("model,f", CASES)
def test_interventional_matches_jax(model, f):
    jf, tf, xq = _forests(model, f, seed=f)
    bg = xq[:9]
    want = np.asarray(jshap.forest_shap_interventional(
        jf, jnp.asarray(xq), jnp.asarray(bg)))
    got = tshap.forest_shap_interventional(tf, torch.from_numpy(xq),
                                           torch.from_numpy(bg))
    assert got.dtype == torch.float32 and got.shape == (23, f)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert np.abs(want).max() > 1e-3
    # the chunking is results-neutral to tolerance
    small = tshap.forest_shap_interventional(tf, torch.from_numpy(xq),
                                             torch.from_numpy(bg), rows=7)
    np.testing.assert_allclose(small.numpy(), got.numpy(), atol=1e-6)
    p0 = ttrees.predict_proba(tf, torch.from_numpy(xq))[:, 0]
    p0b = ttrees.predict_proba(tf, torch.from_numpy(bg))[:, 0]
    np.testing.assert_allclose(got.sum(1).numpy(), (p0 - p0b.mean()).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("model,f", CASES)
def test_interactions_match_jax(model, f):
    jf, tf, xq = _forests(model, f, seed=f + 1)
    want = np.asarray(jshap.forest_shap_interactions(jf, jnp.asarray(xq)))
    x = torch.from_numpy(xq)
    got = tshap.forest_shap_interactions(tf, x)
    assert got.dtype == torch.float32 and got.shape == (23, f, f)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert torch.equal(got, got.transpose(1, 2))
    off = got.numpy() * (1 - np.eye(f))
    assert np.abs(off).max() > 1e-4
    small = tshap.forest_shap_interactions(tf, x, rows=5)
    np.testing.assert_allclose(small.numpy(), got.numpy(), atol=1e-6)
    assert torch.equal(small, small.transpose(1, 2))
    phi = tshap.forest_shap_class0(tf, x)
    np.testing.assert_allclose(got.sum(2).numpy(), phi.numpy(), atol=1e-6)


@pytest.mark.parametrize("model,f", CASES)
def test_path_values_match_graph_engine(model, f):
    """The grid's path mode: the port's packed engine against the JAX
    grid's single-bucket ``_graph_forest_shap``."""
    jf, tf, xq = _forests(model, f, seed=f + 2)
    want = np.asarray(jshap._graph_forest_shap(jf, jnp.asarray(xq), depth=8))
    got = tshap.forest_shap_class0(tf, torch.from_numpy(xq))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_single_leaf_trees_explain_to_zero():
    """A forest whose trees are single leaves has no path rows: every
    value is an exact zero."""
    x = np.random.RandomState(0).randn(40, 5).astype(np.float32)
    y = np.zeros(40, bool)
    jf = jtrees.fit_forest_hist(jnp.asarray(x), jnp.asarray(y),
                                jnp.ones(40), jax.random.PRNGKey(0),
                                n_trees=2, bootstrap=False,
                                random_splits=False, sqrt_features=True,
                                max_depth=4, max_nodes=160)
    tf = forest_from_numpy(jtrees.Forest(*[np.asarray(a) for a in jf]),
                           device="cpu")
    xt = torch.from_numpy(x[:6])
    assert not tshap.forest_shap_interventional(tf, xt, xt).any()
    assert not tshap.forest_shap_interactions(tf, xt).any()
