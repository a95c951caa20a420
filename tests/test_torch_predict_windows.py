"""Predict's ``windows`` walk (``ops/trees.py::_walk_windows``, chosen by
``F16_PREDICT_IMPL`` and sized by ``F16_PREDICT_WINDOW``, both read at
each call) against the port's ``gather`` walk and the JAX package's
``predict_proba(impl="windows")``, all bitwise, at the JAX test's size
(n = 250, 5 trees, depth 16, ``max_nodes=200``: more than one window and
not a multiple of its width), for both growers, for ``predict_batch`` over
folds, and under another width. Every width reaches the same leaves, so
the JAX walk at its import-time width of 128 is the reference at any port
width. The serving store captures the walk through a stand-in capture
that fails on any host read: the plan made by the warm-up run is the
capture's, and the replays equal the eager walks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu.ops import trees as jtrees
from flake16_framework_tpu_torch.kernels import build
from flake16_framework_tpu_torch.obs import aot
from flake16_framework_tpu_torch.ops import trees as ttrees
from flake16_framework_tpu_torch.serve import ModelRegistry
from flake16_framework_tpu_torch.serve.store import ExecutableStore
from flake16_framework_tpu_torch.utils.synth import make_dataset
from flake16_framework_tpu_torch.weights import forest_from_numpy

KW = dict(n_trees=5, bootstrap=True, random_splits=True, sqrt_features=True,
          max_depth=16, max_nodes=200)
GROWERS = {"hist": jtrees.fit_forest_hist, "exact": jtrees.fit_forest}


@pytest.fixture(autouse=True)
def _jax_x64_off(monkeypatch):
    monkeypatch.delenv("F16_PREDICT_IMPL", raising=False)
    monkeypatch.delenv("F16_PREDICT_WINDOW", raising=False)
    with jax.enable_x64(False):
        yield


def _data():
    rs = np.random.RandomState(17)
    x = rs.randn(250, 16).astype(np.float32)
    y = (x[:, 1] + 0.4 * rs.randn(250)) > 0
    return x, y, np.ones(250, np.float32), rs.randn(90, 16).astype(np.float32)


@pytest.fixture(scope="module")
def fitted():
    """{grower: (JAX forests of three keys, their port copies)} and the
    query rows."""
    x, y, w, xq = _data()
    out = {}
    with jax.enable_x64(False):
        for name, fit in GROWERS.items():
            jfs = [fit(x, y, w, jax.random.PRNGKey(k), **KW)
                   for k in (6, 7, 8)]
            out[name] = (jfs, [forest_from_numpy(
                jtrees.Forest(*[np.asarray(a) for a in jf]), device="cpu")
                for jf in jfs])
    return out, xq


@pytest.mark.parametrize("width", [128, 7])
@pytest.mark.parametrize("grower", ["hist", "exact"])
def test_windows_equals_gather_and_the_jax_walk(fitted, grower, width,
                                                monkeypatch):
    forests, xq = fitted
    jf, tf = forests[grower][0][0], forests[grower][1][0]
    assert int(tf.n_nodes.max()) > 128            # crosses into window 2
    assert tf.feature.shape[1] % 128 != 0         # a partial last window
    want = np.asarray(jtrees.predict_proba(jf, jnp.asarray(xq),
                                           impl="windows"))
    x = torch.from_numpy(xq)
    monkeypatch.setenv("F16_PREDICT_WINDOW", str(width))
    got = ttrees.predict_proba(tf, x, impl="windows")
    assert got.numpy().tobytes() == want.tobytes()
    assert torch.equal(got, ttrees.predict_proba(tf, x, impl="gather"))
    plan = ttrees.window_plan(tf, width)
    assert plan.window == width and len(plan.steps) >= 2
    monkeypatch.setenv("F16_PREDICT_IMPL", "windows")
    np.testing.assert_array_equal(ttrees.predict(tf, x).numpy(),
                                  np.asarray(jtrees.predict(jf, xq)))


@pytest.mark.parametrize("grower", ["hist", "exact"])
def test_predict_batch_over_folds(fitted, grower, monkeypatch):
    forests, xq = fitted
    jfs, tfs = forests[grower]
    batch = ttrees.Forest(*(torch.stack(fs) for fs in zip(*(
        f[:-1] for f in tfs))), tfs[0].max_depth)
    x = torch.from_numpy(xq)
    gather = ttrees.predict_batch(batch, x)
    monkeypatch.setenv("F16_PREDICT_IMPL", "windows")
    windows = ttrees.predict_batch(batch, x)
    assert torch.equal(windows, gather)
    for g, jf in enumerate(jfs):
        p = np.asarray(jtrees.predict_proba(jf, jnp.asarray(xq),
                                            impl="windows"))
        np.testing.assert_array_equal(windows[g].numpy(), p[:, 1] > p[:, 0])
        assert torch.equal(windows[g], ttrees.predict(tfs[g], x))


def test_knobs_read_at_each_call(fitted, monkeypatch):
    forests, xq = fitted
    tf = forests["hist"][1][0]
    plans = []
    real = ttrees.window_plan
    monkeypatch.setattr(ttrees, "window_plan",
                        lambda f, w: plans.append(w) or real(f, w))
    x = torch.from_numpy(xq)
    ttrees.predict_proba(tf, x)
    assert plans == []
    monkeypatch.setenv("F16_PREDICT_IMPL", "windows")
    ttrees.predict_proba(tf, x)
    monkeypatch.setenv("F16_PREDICT_WINDOW", "33")
    memo = {}
    ttrees.predict_proba(tf, x, plans=memo)
    ttrees.predict_proba(tf, x, plans=memo)       # the memo's plan
    assert plans == [128, 33] and list(memo) == [33]
    for var, bad in (("F16_PREDICT_WINDOW", "0"),
                     ("F16_PREDICT_IMPL", "windowz")):
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError, match=var):
            ttrees.predict_proba(tf, x)


def _no_host_reads(monkeypatch):
    """Make every device-to-host read of a tensor raise, as one inside a
    CUDA graph capture does."""
    def refuse(*args, **kwargs):
        raise RuntimeError("host read while capturing")

    for name in ("tolist", "item", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def test_store_captures_the_windows_walk(monkeypatch):
    """The store's stand-in capture with host reads refused while it
    captures and replays: the warm-up run made the plan, so the capture
    reads nothing; each replay equals the eager windows and gather walks
    bitwise."""
    feats, labels, _ = make_dataset(n_tests=160, n_projects=4, seed=3)
    reg = ModelRegistry(None, device="cpu")
    model = reg.fit_and_register(
        ("NOD", "Flake16", "Scaling", "SMOTE Tomek", "Extra Trees"), feats,
        labels, max_depth=8, tree_overrides={"Extra Trees": 4}, seed=3,
        persist=False)
    walks = []

    def capture(fn, static_x):
        with monkeypatch.context() as m:
            _no_host_reads(m)
            out = fn(static_x)

        def replay():
            with monkeypatch.context() as m, build.capture_tally(), \
                    aot.uncounted():
                _no_host_reads(m)
                out.copy_(fn(static_x))

        walks.append(ttrees.predict_impl())
        return replay, out

    store = ExecutableStore(reg, device="cpu")
    for cache in store._caches.values():
        cache._capture = capture
    monkeypatch.setenv("F16_PREDICT_IMPL", "windows")
    monkeypatch.setenv("F16_PREDICT_WINDOW", "16")
    store.warm(model, (8,))
    prep = store._prepare(model)
    assert list(prep.walk_plans) == [16] and walks == ["windows"] * 2
    x = np.ascontiguousarray(feats[:8][:, list(model.cols)],
                             dtype=np.float32)
    got = store.call(model, "predict", x)
    fn, args, _ = store.audit_handles(model, x)["serve.predict"]
    assert torch.equal(got, fn(*args))
    monkeypatch.setenv("F16_PREDICT_IMPL", "gather")
    assert torch.equal(got, fn(*args))
    assert torch.equal(store.call(model, "predict", x), got)
