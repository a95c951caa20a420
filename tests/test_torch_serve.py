"""The port's scoring service (``flake16_framework_tpu_torch.serve``)
against the JAX package's (``flake16_framework_tpu.serve``), all on the
CPU with tiny models: the registry's fit bitwise (forest, mu, W), each
package loading the other's persisted registry, register -> persist ->
reload keeping every dispatch key, served predict and SHAP against the
JAX package's ``trees.predict_proba`` and ``treeshap._xla_forest_shap``
on the same forest and rows (rtol 1e-5, atol 1e-6), the microbatcher's
padding and coalescing, admission control, the queue, failover and
quarantine through the dispatch guard, the three drain paths, the CLI
and the device rule (no CUDA, no service unless the CPU is asked for)."""

import json
import os
import pickle
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu import config as jcfg
from flake16_framework_tpu.ops import trees as jtrees
from flake16_framework_tpu.ops import treeshap as jshap
from flake16_framework_tpu.ops.preprocess import transform as jtransform
from flake16_framework_tpu.serve import registry as jregistry
from flake16_framework_tpu_torch import __main__ as tmain
from flake16_framework_tpu_torch.resilience import faults, guard, inject
from flake16_framework_tpu_torch.serve import (
    ExecutableStore, ModelRegistry, RequestQueue, RequestRejected,
    RetriableRejection, ScoreRequest, ScoringService, artifact_signature,
    model_id_for,
)
from flake16_framework_tpu_torch.serve import registry as tregistry
from flake16_framework_tpu_torch.serve import store as tstore
from flake16_framework_tpu_torch.serve.cli import serve_main
from flake16_framework_tpu_torch.serve.queue import ServeError
from flake16_framework_tpu_torch.utils.synth import make_dataset

# One tiny tree config (single tree, exact grower) and one tiny ensemble
# config (hist grower, T > 1) — both on-grid, so config_index resolves
# for fault injection.
DT_CONFIG = ("NOD", "Flake16", "None", "None", "Decision Tree")
ET_CONFIG = ("NOD", "Flake16", "Scaling", "SMOTE Tomek", "Extra Trees")
RF_CONFIG = ("NOD", "Flake16", "Scaling", "SMOTE Tomek", "Random Forest")
TINY = {"Extra Trees": 4, "Random Forest": 4}
MAX_DEPTH = 6
BUCKETS = (4, 16)
FIT = dict(max_depth=MAX_DEPTH, tree_overrides=TINY, seed=3)


@pytest.fixture(autouse=True)
def _jax_x64_off(monkeypatch):
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites); no
    backoff between the dispatch guard's attempts."""
    monkeypatch.setenv("F16_FAULT_BACKOFF_S", "0")
    monkeypatch.delenv(inject.ENV_VAR, raising=False)
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def data():
    feats, labels, _ = make_dataset(n_tests=160, seed=7)
    return feats, labels


@pytest.fixture(scope="module")
def registry(data, tmp_path_factory):
    feats, labels = data
    reg = ModelRegistry(str(tmp_path_factory.mktemp("serve-registry")),
                        device="cpu")
    with jax.enable_x64(False):
        for keys in (DT_CONFIG, ET_CONFIG):
            reg.fit_and_register(keys, feats, labels, **FIT)
    return reg


@pytest.fixture(scope="module")
def service(registry):
    svc = ScoringService(registry, buckets=BUCKETS, device="cpu")
    svc.start()
    yield svc
    svc.stop()


def _jax_forest(model):
    """The port model's forest as the JAX package's ``Forest``."""
    forest, _, _ = tregistry._artifact_arrays(model)
    return jtrees.Forest(*[jnp.asarray(forest[f])
                           for f in jtrees.Forest._fields])


def _jax_direct(forest, mu, wmat, cols, x, kind):
    """The JAX package's direct call, as its serve tests make it."""
    xp = jtransform(np.asarray(x[:, list(cols)], np.float32),
                    jnp.asarray(mu), jnp.asarray(wmat))
    if kind == "predict":
        return np.asarray(jtrees.predict_proba(forest, xp))
    return np.asarray(jshap._xla_forest_shap(forest, xp,
                                             depth=int(forest.max_depth)))


def _direct(model, x, kind):
    return _jax_direct(_jax_forest(model), model.mu.numpy(),
                       model.wmat.numpy(), model.cols, x, kind)


# -- registry ------------------------------------------------------------


# The ET config without its scaler: the scaler's column means and
# variances differ by an ulp between XLA and PyTorch (and between the JAX
# package's jitted and eager calls), and so may the forests grown on the
# scaled samples.
ET_UNSCALED = ("NOD", "Flake16", "None", "SMOTE Tomek", "Extra Trees")


def _fit_both(data, keys):
    feats, labels = data
    want = jregistry.fit_model(keys, feats, labels, **FIT)
    got = tregistry.fit_model(keys, feats, labels, device="cpu", **FIT)
    assert (got.model_id, got.config_index, got.cols, got.depth) == (
        want.model_id, want.config_index, want.cols, want.depth)
    return want, got


@pytest.mark.parametrize("keys", [DT_CONFIG, ET_UNSCALED, RF_CONFIG[:2] + (
    "None",) + RF_CONFIG[3:]], ids=["dt", "et", "rf"])
def test_fit_model_matches_jax(data, keys):
    """The registry's fit against the JAX ``serve.registry.fit_model`` on
    the same data and seed: forest (trimmed), mu and W bitwise."""
    want, got = _fit_both(data, keys)
    forest, mu, wmat = tregistry._artifact_arrays(got)
    for f in jtrees.Forest._fields:
        a, b = forest[f], np.asarray(getattr(want.forest, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for a, b in ((mu, want.mu), (wmat, want.wmat)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_fit_model_scaled_matches_jax(data):
    """The scaled ET config: mu and W within an ulp's rtol (1e-6) of the
    JAX package's, the forest of the same shapes and trim."""
    want, got = _fit_both(data, ET_CONFIG)
    forest, mu, wmat = tregistry._artifact_arrays(got)
    np.testing.assert_allclose(mu, np.asarray(want.mu), rtol=1e-6)
    np.testing.assert_allclose(wmat, np.asarray(want.wmat), rtol=1e-6)
    for f in jtrees.Forest._fields:
        b = np.asarray(getattr(want.forest, f))
        assert forest[f].dtype == b.dtype and forest[f].shape == b.shape, f


def test_torch_registry_loads_in_jax(registry, service, data):
    """The JAX package's ``load()`` reads the port's registry directory:
    the same arrays, and its direct calls give what the port serves."""
    feats, _ = data
    jreg = jregistry.ModelRegistry(registry.root)
    assert [m.model_id for m in jreg.load()] == registry.ids()
    for model_id in registry.ids():
        jm, tm = jreg.get(model_id), registry.get(model_id)
        assert jm.config_keys == tm.config_keys and jm.cols == tm.cols
        for kind in ("predict", "shap"):
            want = _jax_direct(jm.forest, jm.mu, jm.wmat, jm.cols,
                               feats[:5], kind)
            got = service.score(model_id, feats[:5], kind=kind, timeout=60)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_jax_registry_loads_in_torch(data, tmp_path):
    """The port's ``load()`` reads the JAX package's registry directory:
    the same arrays, and the port serves what the JAX direct calls give."""
    feats, labels = data
    jreg = jregistry.ModelRegistry(str(tmp_path / "jax-registry"))
    for keys in (DT_CONFIG, ET_CONFIG):
        jreg.fit_and_register(keys, feats, labels, **FIT)
    treg = ModelRegistry(jreg.root, device="cpu")
    assert [m.model_id for m in treg.load()] == jreg.ids()
    with ScoringService(treg, buckets=BUCKETS, device="cpu") as svc:
        for model_id in jreg.ids():
            jm, tm = jreg.get(model_id), treg.get(model_id)
            forest, _, _ = tregistry._artifact_arrays(tm)
            for f in jtrees.Forest._fields:
                assert forest[f].tobytes() == np.asarray(
                    getattr(jm.forest, f)).tobytes(), f
            for kind in ("predict", "shap"):
                want = _jax_direct(jm.forest, jm.mu, jm.wmat, jm.cols,
                                   feats[:5], kind)
                got = svc.score(model_id, feats[:5], kind=kind, timeout=60)
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_registry_round_trip(registry):
    """Register -> persist -> reload -> identical dispatch signatures at
    every bucket (computed without running anything), and the index's
    digests are those of the reloaded models."""
    fresh = ModelRegistry(registry.root, device="cpu")
    loaded = fresh.load()
    assert [m.model_id for m in loaded] == registry.ids()
    store_a = ExecutableStore(registry, device="cpu")
    store_b = ExecutableStore(fresh, device="cpu")
    for model_id in registry.ids():
        a, b = registry.get(model_id), fresh.get(model_id)
        assert artifact_signature(a) == artifact_signature(b)
        for bucket in BUCKETS:
            sa, sb = store_a.signatures(a, bucket), store_b.signatures(b,
                                                                       bucket)
            assert sa == sb and set(sa) == set(tstore.KINDS)
    with open(os.path.join(registry.root, "registry.json")) as fd:
        index = json.load(fd)
    assert index["schema"] == tregistry.REGISTRY_SCHEMA
    for model_id, entry in index["models"].items():
        assert entry["signature_sha1"] == \
            tregistry.signature_digest(fresh.get(model_id))


def test_equal_shapes_share_dispatch_keys(data, tmp_path):
    """Models with equal artifact shapes (an ET and an RF config) share
    one dispatch key for each (kind, bucket), before and after a reload;
    the config code keeps their artifact signatures apart."""
    feats, labels = data
    reg = ModelRegistry(str(tmp_path / "reg"), device="cpu")
    et, rf = (reg.fit_and_register(keys, feats, labels, **FIT)
              for keys in (ET_CONFIG, RF_CONFIG))
    store = ExecutableStore(reg, device="cpu")
    assert artifact_signature(et) != artifact_signature(rf)
    keys = set()
    for model in (et, rf):
        sigs = store.warm(model, BUCKETS)
        assert set(sigs) == {(k, b) for k in tstore.KINDS for b in BUCKETS}
        keys |= set(sigs.values())
    assert len(keys) == len(tstore.KINDS) * len(BUCKETS)
    fresh = ModelRegistry(reg.root, device="cpu")
    fresh.load()
    for model in fresh.models():
        assert set(store.warm(model, BUCKETS).values()) <= keys


def test_model_identity(registry):
    assert model_id_for(DT_CONFIG) == "nod-flake16-none-none-decisiontree"
    assert model_id_for(DT_CONFIG) == jregistry.model_id_for(DT_CONFIG)
    want = list(jcfg.iter_config_keys()).index(DT_CONFIG)
    assert registry.get(model_id_for(DT_CONFIG)).config_index == want
    assert tregistry.config_index_for(ET_CONFIG) == \
        jregistry.config_index_for(ET_CONFIG)
    assert tregistry.config_index_for(("bogus",) * 5) is None


def test_configs_from_ledger(tmp_path):
    ledger = {ET_CONFIG: [0.1] * 4, DT_CONFIG: [0.2] * 4}
    path = tmp_path / "scores.pkl"
    path.write_bytes(pickle.dumps(ledger))
    got = tregistry.configs_from_ledger(str(path))
    # canonical 216-order, regardless of dict insertion order
    assert got == [k for k in jcfg.iter_config_keys() if k in ledger]
    assert got == jregistry.configs_from_ledger(str(path))
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(pickle.dumps([1, 2]))
    with pytest.raises(ValueError):
        tregistry.configs_from_ledger(str(bad))


# -- serving correctness -------------------------------------------------


def test_predict_and_shap_match_jax(service, registry, data):
    feats, _ = data
    for model_id in registry.ids():
        model = registry.get(model_id)
        for kind in ("predict", "shap"):
            got = service.score(model_id, feats[:3], kind=kind, timeout=60)
            assert got.dtype == np.float32
            assert got.shape == (3, 2 if kind == "predict" else 16)
            np.testing.assert_allclose(
                got, _direct(model, feats[:3], kind), rtol=1e-5, atol=1e-6)


def test_padding_and_coalescing(service, registry, data):
    """Concurrent 3-, 5-, 4- and 1-row requests pad into shared buckets;
    each caller gets exactly its own rows back."""
    feats, _ = data
    model_id = registry.ids()[0]
    model = registry.get(model_id)
    spans = ((0, 3), (3, 5), (8, 4), (12, 1))
    for kind in ("predict", "shap"):
        reqs = [service.submit(model_id, feats[off:off + n], kind=kind)
                for off, n in spans]
        outs = [r.result(timeout=60) for r in reqs]
        for (off, n), out in zip(spans, outs):
            assert out.shape[0] == n
            np.testing.assert_allclose(
                out, _direct(model, feats[off:off + n], kind), rtol=1e-5,
                atol=1e-6)
    stats = service.stats()
    assert stats["requests"] >= 8 and not stats["quarantined"]


def test_concurrent_clients_stress(service, registry, data):
    """More client threads than cores, with a short switch interval: every
    request completes with its own rows, and the latency count grows by
    exactly the number of requests."""
    feats, _ = data
    model_id = registry.ids()[1]
    model = registry.get(model_id)
    want = _direct(model, feats[:32], "predict")
    before = service.stats()["requests"]
    bad = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(ci):
            for i in range(4):
                off = (ci + i) % 16
                got = service.score(model_id, feats[off:off + 2],
                                    timeout=60)
                if not np.allclose(got, want[off:off + 2], rtol=1e-5,
                                   atol=1e-6):
                    bad.append((ci, i))

        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not bad
    assert service.stats()["requests"] == before + 64


def test_admission_control(service, registry, data):
    feats, _ = data
    with pytest.raises(RequestRejected):
        service.submit("no-such-model", feats[:2])
    with pytest.raises(RequestRejected):
        service.submit(registry.ids()[0], feats[:2], kind="explode")
    with pytest.raises(RequestRejected):  # rows above the largest bucket
        service.submit(registry.ids()[0], feats[:BUCKETS[-1] + 1])
    with pytest.raises(RequestRejected):  # feature width mismatch
        service.submit(registry.ids()[0], feats[:2, :3])


def test_queue_bounds_and_close(data):
    feats, _ = data
    q = RequestQueue(maxsize=1)
    q.submit(ScoreRequest("m", feats[:2]))
    with pytest.raises(RequestRejected):
        q.submit(ScoreRequest("m", feats[:2]))
    assert q.depth() == 1
    q.close()
    with pytest.raises(RequestRejected):
        q.submit(ScoreRequest("m", feats[:2]))
    # FIFO coalescing only takes same-(model, kind) requests
    q2 = RequestQueue()
    q2.submit(ScoreRequest("a", feats[:2]))
    q2.submit(ScoreRequest("b", feats[:2]))
    q2.submit(ScoreRequest("a", feats[:2], kind="shap"))
    q2.submit(ScoreRequest("a", feats[:2]))
    batch = q2.take_batch(max_rows=16)
    assert [(r.model_id, r.kind) for r in batch] == [("a", "predict")] * 2
    assert q2.depth() == 2
    assert q2.take_batch(max_rows=1, wait_s=0.0) == []  # 2 rows > budget


# -- failover ------------------------------------------------------------


def test_serving_failover_oom(registry, data, monkeypatch):
    """An injected ``oom`` on the first attempt of every serve dispatch:
    the guard retries and the request completes, with the retry in
    ``guard.retries`` and nothing quarantined."""
    feats, _ = data
    monkeypatch.setenv(inject.ENV_VAR, "*:1:oom")
    with ScoringService(registry, buckets=BUCKETS, device="cpu") as svc:
        model_id = registry.ids()[0]
        out = svc.score(model_id, feats[:3], kind="shap", timeout=60)
        np.testing.assert_allclose(
            out, _direct(registry.get(model_id), feats[:3], "shap"),
            rtol=1e-5, atol=1e-6)
        assert not svc.stats()["quarantined"]
        retries = svc.batcher.guard.retries
        assert len(retries) >= 1
        assert retries[0]["fault_class"] == faults.OOM
        assert retries[0]["label"] == f"serve:{model_id}:shap"


@pytest.mark.parametrize("which", ["every", "one"])
def test_quarantine_after_abandon(registry, data, monkeypatch, which):
    """A model whose dispatch the guard abandons is quarantined: the
    in-flight request fails with DispatchAbandoned, later submissions are
    rejected at admission. With the fault on one config only, the other
    model keeps serving."""
    feats, _ = data
    bad, other = registry.ids()
    index = registry.get(bad).config_index
    monkeypatch.setenv(inject.ENV_VAR, "*:*:deterministic" if which ==
                       "every" else f"{index}:*:deterministic")
    with ScoringService(registry, buckets=BUCKETS, device="cpu") as svc:
        req = svc.submit(bad, feats[:2])
        with pytest.raises(guard.DispatchAbandoned):
            req.result(timeout=60)
        deadline = time.time() + 10
        while bad not in svc.stats()["quarantined"] \
                and time.time() < deadline:
            time.sleep(0.01)
        rec = svc.stats()["quarantined"][bad]
        assert rec["fault_class"] == faults.DETERMINISTIC
        assert rec["attempts"] == 1 and rec["kind"] == "predict"
        with pytest.raises(RequestRejected, match="quarantined"):
            svc.submit(bad, feats[:2])
        if which == "one":
            out = svc.score(other, feats[:2], kind="shap", timeout=60)
            np.testing.assert_allclose(
                out, _direct(registry.get(other), feats[:2], "shap"),
                rtol=1e-5, atol=1e-6)
            assert other not in svc.stats()["quarantined"]


def test_warm_failure_stops_start(registry, monkeypatch):
    """A failing SHAP program at warm propagates from ``start()``: the
    service does not start and serves nothing."""
    def broken(*args):
        raise RuntimeError("treeshap_unit launch failed: CUDA error 209")

    monkeypatch.setattr(tstore.treeshap, "graph_shap", broken)
    svc = ScoringService(registry, buckets=BUCKETS, device="cpu")
    with pytest.raises(RuntimeError, match="treeshap_unit"):
        svc.start()
    assert not svc.batcher._threads


# -- graceful drain ------------------------------------------------------


def test_drain_under_load_completes_and_flushes(registry, data):
    """Admission close -> in-flight complete -> flush. Every submitted
    request either completes or fails RETRIABLY (nothing dropped),
    post-drain submits are retriable rejections, and the flushed warm
    manifest equals a fresh registry's and store's (nothing run)."""
    feats, _ = data
    svc = ScoringService(registry, buckets=BUCKETS, device="cpu")
    svc.start()
    model_id = registry.ids()[0]
    reqs = [svc.submit(model_id, feats[:3]) for _ in range(6)]
    acct = svc.drain(deadline_s=30.0)
    assert acct["phase"] == "complete" and acct["aborted"] == 0

    done = retried = 0
    for r in reqs:
        try:
            out = r.result(timeout=5)
            assert out.shape[0] == 3
            done += 1
        except RetriableRejection:
            retried += 1
    assert done + retried == 6          # zero dropped
    assert acct["rejected"] == retried
    assert acct["completed"] >= done

    with pytest.raises(RetriableRejection) as ei:
        svc.submit(model_id, feats[:3])
    assert ei.value.retriable is True
    assert isinstance(ei.value, RequestRejected)

    manifest_path = os.path.join(registry.root, tstore.MANIFEST_FILE)
    with open(manifest_path) as fd:
        manifest = json.load(fd)
    assert manifest["schema"] == tstore.MANIFEST_SCHEMA
    assert manifest["backend"] == "cpu"
    assert tuple(manifest["buckets"]) == BUCKETS
    assert set(manifest["models"]) == set(registry.ids())
    fresh = ModelRegistry(registry.root, device="cpu")
    fresh.load()
    rebuilt = ExecutableStore(fresh, device="cpu").warm_manifest(
        fresh.models(), tuple(manifest["buckets"]))
    assert rebuilt == manifest["models"]


def test_drain_rejects_queued_retriably(data):
    """Queue half of the drain contract: close() + drain_pending() hands
    back the unstarted requests; failing them with RetriableRejection
    reaches every waiting future."""
    feats, _ = data
    q = RequestQueue(maxsize=4)
    reqs = [ScoreRequest("m", feats[:2]) for _ in range(3)]
    for r in reqs:
        q.submit(r)
    q.close()
    with pytest.raises(RetriableRejection, match="resubmit"):
        q.submit(ScoreRequest("m", feats[:2]))
    items = q.drain_pending()
    assert items == reqs and q.drain_pending() == []
    exc = RetriableRejection("draining")
    for r in items:
        r._fail(exc)
    for r in reqs:
        with pytest.raises(RetriableRejection):
            r.result(timeout=1)


def test_drain_deadline_escalates_to_abort(registry, data, monkeypatch):
    """Past the deadline the drain checkpoints-and-aborts: handed-off but
    undispatched batches fail with a non-retriable ServeError, the flush
    still runs, and the accounting says phase=abort."""
    feats, _ = data
    svc = ScoringService(registry, buckets=BUCKETS, device="cpu")
    svc.start()
    real_stop = svc.batcher.stop
    monkeypatch.setattr(svc.batcher, "stop", lambda timeout=5.0: False)
    manifest = os.path.join(registry.root, tstore.MANIFEST_FILE)
    if os.path.exists(manifest):
        os.remove(manifest)
    # Stop the real workers first, so none of them takes the wedged batch.
    assert real_stop(timeout=10)
    wedged = [ScoreRequest(registry.ids()[0], feats[:2]) for _ in range(2)]
    svc.batcher._handoff.put(list(wedged))
    acct = svc.drain(deadline_s=0.01)
    assert acct["phase"] == "abort" and acct["aborted"] == 2
    for r in wedged:
        with pytest.raises(ServeError) as ei:
            r.result(timeout=1)
        assert not getattr(ei.value, "retriable", False)
        assert "deadline" in str(ei.value)
    assert os.path.exists(manifest)


# -- CLI and device rule -------------------------------------------------


def test_serve_cli_smoke(capsys):
    code = serve_main(["--synth", "120", "--trees", "2", "--max-depth",
                       "4", "--requests", "8", "--rows", "4",
                       "--clients", "2", "--buckets", "4,8", "--kinds",
                       "predict,shap", "--json"], device="cpu")
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and stats["n_errors"] == 0
    assert stats["requests"] == 8 and stats["rps"] > 0
    assert stats["p99_ms"] is not None and stats["device"] == "cpu"
    assert stats["kinds"] == ["predict", "shap"]
    assert len(stats["models"]) == 2


@pytest.mark.parametrize("flag,queue", [("--metrics-port", "§A 6")])
def test_serve_cli_rejects_later_flags(flag, queue):
    """The JAX package's exporter flag raises, naming the ROADMAP.md queue
    that brings it, through the port's command line. (Its SLO and fleet
    flags parse: tests/test_torch_fleet.py.)"""
    with pytest.raises(ValueError, match=f"not in the port yet.*{queue}"):
        tmain.main(["serve", flag, "1"])


def test_serve_cli_rejects_unknown_flag():
    with pytest.raises(ValueError, match="Unrecognized serve option"):
        serve_main(["--bogus"], device="cpu")


def test_serve_needs_cuda_unless_asked(registry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScoringService(registry)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRegistry(registry.root)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main(["--synth", "120", "--trees", "2", "--requests", "2"])
