"""The executable store's cache (``obs/aot.py``) and the dispatch census
(``obs/costs.py``), on the CPU. The cache's keys equal the store's
``signatures()`` (the warm manifest's digests); the census counts with
telemetry off; the audit's eager bodies stay out of it; the graph
bookkeeping (one capture a (model, kind, bucket), a reload dropping the
model's graphs, the launches a capture recorded added at every replay, a
capture error stopping the service at start, concurrent replays) runs
through a stand-in capture, since the CPU has no CUDA graph, and without
one a ``cpu`` cache runs the eager body."""

import threading

import jax
import numpy as np
import pytest
import torch

from flake16_framework_tpu_torch.kernels import build, treeshap_unit
from flake16_framework_tpu_torch.obs import aot
from flake16_framework_tpu_torch.serve import ModelRegistry, ScoringService
from flake16_framework_tpu_torch.serve.store import (
    KINDS, ExecutableStore, signature_digest,
)
from flake16_framework_tpu_torch.serve.registry import artifact_signature
from flake16_framework_tpu_torch.utils.synth import make_dataset

BUCKETS = (4, 16)


@pytest.fixture(autouse=True)
def _jax_x64_off(monkeypatch):
    monkeypatch.setenv("F16_PERFDB", "0")
    monkeypatch.setenv("F16_FAULT_BACKOFF_S", "0")
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def served():
    """A CPU registry of a Decision Tree and a 4-tree Extra Trees model,
    and the raw features."""
    feats, labels, _ = make_dataset(n_tests=160, n_projects=4, seed=3)
    reg = ModelRegistry(None, device="cpu")
    for keys in (("NOD", "Flake16", "None", "None", "Decision Tree"),
                 ("NOD", "Flake16", "Scaling", "SMOTE Tomek",
                  "Extra Trees")):
        reg.fit_and_register(keys, feats, labels, max_depth=6,
                             tree_overrides={"Extra Trees": 4}, seed=3,
                             persist=False)
    return reg, np.asarray(feats)


def _batch(model, feats, rows):
    return np.ascontiguousarray(feats[:rows][:, list(model.cols)],
                                dtype=np.float32)


def _graph_capture(calls=None):
    """A stand-in for ``cuda_graph_capture``: runs the body once on the
    static input as the capture, and replays as a graph does: the body's
    arithmetic again into the static output, outside every launch count
    and the dispatch census."""
    def capture(fn, static_x):
        out = fn(static_x)
        if calls is not None:
            calls.append(tuple(static_x.shape))

        def replay():
            with build.capture_tally(), aot.uncounted():
                out.copy_(fn(static_x))

        return replay, out

    return capture


def _graph_store(registry, capture=None):
    store = ExecutableStore(registry, device="cpu")
    for cache in store._caches.values():
        cache._capture = capture or _graph_capture()
    return store


def test_keys_equal_the_store_signatures(served):
    """``warm`` returns, for every (kind, bucket), the key
    ``signatures()`` computes without running anything: the JAX store's
    layout (name, artifact shapes, batch shape, and the depth for SHAP),
    whose digests the warm manifest holds."""
    reg, _ = served
    store = ExecutableStore(reg, device="cpu")
    for model in reg.models():
        sigs = store.warm(model, BUCKETS)
        shapes = artifact_signature(model)[1]
        for bucket in BUCKETS:
            want = store.signatures(model, bucket)
            x = ((bucket, len(model.cols)), "float32")
            assert want == {"predict": ("serve.predict", shapes, x),
                            "shap": ("serve.shap", shapes, x, model.depth)}
            for kind in KINDS:
                assert sigs[(kind, bucket)] == want[kind]
                assert store.warm_manifest([model], BUCKETS)[
                    model.model_id][f"{kind}@{bucket}"] == \
                    signature_digest(want[kind])


def test_census_counts_with_telemetry_off(served):
    """With telemetry off, each served call counts its cache's dispatch
    and the instrumented entry points its body runs (predict: the forest
    walk; SHAP: the single-bucket program and the unit), and the CPU
    captures nothing."""
    reg, feats = served
    store = ExecutableStore(reg, device="cpu")
    model = reg.models()[1]
    store.warm(model, BUCKETS)
    before = aot.dispatch_stats()
    x = _batch(model, feats, 4)
    for _ in range(3):
        store.call(model, "predict", x)
    store.call(model, "shap", x)
    after = aot.dispatch_stats()
    assert after["dispatches"] - before["dispatches"] == 3 * 2 + 3
    assert after["compiles"] == before["compiles"]
    assert all(not c.graphs() for c in store._caches.values())


def test_cpu_cache_runs_the_eager_body(served):
    """Without a capture a ``cpu`` cache runs its body at every call, on
    the batch as given, and holds no graph."""
    seen = []

    def body(scale, x):
        seen.append(x.shape)
        return x * scale

    cache = aot.AotExecutableCache(body, "t.eager",
                                   lambda a, k: (np.shape(a[-1]),),
                                   device="cpu")
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    assert cache.warm("m", 2.0, x) == ("t.eager", (3, 2))
    out = cache("m", 2.0, x)
    assert torch.equal(out, torch.from_numpy(x) * 2)
    assert seen == [(3, 2), (3, 2)] and cache.graphs() == {}


def test_audit_bodies_stay_out_of_the_census(served):
    """``audit_handles`` hands out the caches' eager bodies: running them
    bumps no dispatch count, and they equal the served calls."""
    reg, feats = served
    store = ExecutableStore(reg, device="cpu")
    model = reg.models()[1]
    x = _batch(model, feats, 4)
    handles = store.audit_handles(model, x)
    assert set(handles) == {"serve.predict", "serve.shap"}
    before = aot.dispatch_stats()
    got = {name: fn(*args, **kw) for name, (fn, args, kw) in handles.items()}
    assert aot.dispatch_stats() == before
    for kind in KINDS:
        assert torch.equal(got[f"serve.{kind}"], store.call(model, kind, x))


def test_graphs_one_a_triple_and_reload_recaptures(served):
    """Through a stand-in capture: ``warm`` captures one graph a (model,
    kind, bucket), each a compile; calls replay (no compile) and equal the
    eager body; a reload (a new model object for the id) drops that
    model's graphs, and the next call captures its signature again."""
    reg, feats = served
    calls = []
    store = _graph_store(reg, _graph_capture(calls))
    eager = ExecutableStore(reg, device="cpu")
    c0 = aot.dispatch_stats()["compiles"]
    for model in reg.models():
        store.warm(model, BUCKETS)
    n = len(reg) * len(KINDS) * len(BUCKETS)
    assert aot.dispatch_stats()["compiles"] - c0 == n == len(calls)
    for model in reg.models():
        x = _batch(model, feats, 16)
        for kind in KINDS:
            assert torch.equal(store.call(model, kind, x),
                               eager.call(model, kind, x))
    assert aot.dispatch_stats()["compiles"] - c0 == n
    model = reg.models()[1]
    twin = type(model)(**{k: getattr(model, k) for k in model.__slots__})
    owners = [k[0] for c in store._caches.values() for k in c.graphs()]
    assert owners.count(model.model_id) == len(KINDS) * len(BUCKETS)
    reg.register(twin, persist=False)
    try:
        x = _batch(twin, feats, 4)
        out = store.call(twin, "shap", x)
        assert aot.dispatch_stats()["compiles"] - c0 == n + 1
        owners = [k[0] for c in store._caches.values() for k in c.graphs()]
        assert owners.count(model.model_id) == 1
        assert torch.equal(out, eager.call(twin, "shap", x))
    finally:
        reg.register(model, persist=False)


def test_replays_add_the_launches_the_capture_recorded():
    """A launch made while capturing goes to the capture's tally, not to
    the count; each replay adds the tally, so a replayed kernel counts as
    an eager launch does. The warm-up run before the capture is a real
    launch."""
    def body(x):
        build.count_launch(treeshap_unit.unit_shap)
        return x + 1

    cache = aot.AotExecutableCache(body, "t.graph",
                                   lambda a, k: (np.shape(a[-1]),),
                                   device="cpu", capture=_graph_capture())
    x = np.zeros((2, 3), dtype=np.float32)
    k2 = treeshap_unit.unit_shap.launches
    cache.warm("m", x)
    assert treeshap_unit.unit_shap.launches - k2 == 1     # the warm-up run
    (info,) = cache.graphs().values()
    assert info.launches == {treeshap_unit.unit_shap: 1}
    assert info.capture_s >= 0
    for i in range(5):
        assert torch.equal(cache("m", x + i), torch.from_numpy(x + i + 1))
    assert treeshap_unit.unit_shap.launches - k2 == 6


def test_capture_error_stops_the_service_at_start(served):
    """A capture that fails (the stand-in raises as a CUDA graph capture
    of an uncapturable body would) propagates from ``warm``, and the
    service does not start: no fallback to the eager body."""
    reg, feats = served

    def broken(fn, static_x):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    svc = ScoringService(reg, buckets=BUCKETS, device="cpu")
    svc.store._caches["shap"]._capture = broken
    with pytest.raises(RuntimeError, match="capturing"):
        svc.start()
    assert not svc.batcher._threads
    store = _graph_store(reg, broken)
    with pytest.raises(RuntimeError, match="capturing"):
        store.warm(reg.models()[0], BUCKETS)
    with pytest.raises(RuntimeError, match="capturing"):
        store.call(reg.models()[0], "predict", _batch(reg.models()[0],
                                                      feats, 4))


def test_concurrent_replays_get_their_own_answers(served):
    """Two threads replaying one graph with different batches: the graph's
    lock holds its static input and output for one caller from copy-in to
    clone, so each gets its own batch's answer."""
    reg, feats = served
    store = _graph_store(reg)
    eager = ExecutableStore(reg, device="cpu")
    model = reg.models()[1]
    store.warm(model, (16,))
    xs = [np.ascontiguousarray(feats[i * 16:(i + 1) * 16][:, list(model.cols)],
                               dtype=np.float32) for i in range(2)]
    want = [eager.call(model, "shap", x) for x in xs]
    bad = []

    def run(i):
        for _ in range(40):
            if not torch.equal(store.call(model, "shap", xs[i]), want[i]):
                bad.append(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad and not torch.equal(want[0], want[1])
