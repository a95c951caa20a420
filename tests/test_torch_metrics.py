"""The port's live metrics exporter (``obs/metrics.py``) against the JAX
package's, on the CPU: the same registry of fixed sources renders the
same bytes and validates alike in both packages; the port service's
``/metrics`` body is valid under the JAX package's validator and exposes
the JAX package's series less the seven whose sources the port leaves
out; ``serve --metrics-port`` in one process; the process sources read
the journal's fold lag; and the census contract (the JAX package's lint
rule O105, carried as a scan): every literal name the package passes to
``obs.gauge``/``obs.counter_add`` is in ``METRIC_CENSUS``, and the census
holds no other name. The fleet's federated endpoint is held in
``tests/test_torch_fleet.py``."""

import ast
import json
import os
import types
import urllib.request

import jax
import numpy as np
import pytest

from flake16_framework_tpu.obs import metrics as jmetrics
from flake16_framework_tpu.obs.slo import SLOConfig as JSLOConfig
from flake16_framework_tpu.obs.slo import SLOMonitor as JSLOMonitor
from flake16_framework_tpu.serve.service import ScoringService as JService
from flake16_framework_tpu_torch import obs as tobs
from flake16_framework_tpu_torch.obs import metrics as tmetrics
from flake16_framework_tpu_torch.obs.slo import SLOConfig
from flake16_framework_tpu_torch.resilience import journal as tjournal
from flake16_framework_tpu_torch.serve import ModelRegistry, ScoringService
from flake16_framework_tpu_torch.serve.cli import serve_main
from flake16_framework_tpu_torch.utils.synth import make_dataset

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "flake16_framework_tpu_torch")
# The JAX package's series whose source the port leaves out on purpose:
# the degradation ladder. (The dispatch census and the compile-cache
# series have the port's sources, obs/aot.py and the kernel build cache.)
LEFT_OUT = {"f16_ladder_halvings", "f16_ladder_cpu_fallback",
            "f16_ladder_pallas_broken"}
DT_CONFIG = ("NOD", "Flake16", "None", "None", "Decision Tree")
ET_CONFIG = ("NOD", "Flake16", "Scaling", "SMOTE Tomek", "Extra Trees")


@pytest.fixture(autouse=True)
def _jax_x64_off(monkeypatch):
    monkeypatch.setenv("F16_PERFDB", "0")
    with jax.enable_x64(False):
        yield


def _fill(mod):
    """One registry of fixed sources of every form a source may take."""
    reg = mod.MetricsRegistry()
    reg.register("f16_int", lambda: 7, help="An int.")
    reg.register("f16_float", lambda: 0.125, help="A float.")
    reg.register("f16_big", lambda: 3e15, kind="counter")
    reg.register("f16_whole_float", lambda: 12.0)
    reg.register("f16_neg", lambda: -2.5, help="Below zero.")
    reg.register("f16_absent", lambda: None, help="Skipped.")
    reg.register("f16_raises", lambda: 1 / 0, help="Skipped too.")
    reg.register("f16_text", lambda: "x", help="Not a number.")
    reg.register("f16_labelled", lambda: {"b": 2, "a": 1.5, "c": "no"},
                 label="worker", help='Quotes " and \\ in "help".')
    reg.register("f16_escaped", lambda: {'q"uo\\te\nd': 1}, kind="counter")
    reg.register("f16_empty_dict", lambda: {})
    reg.register("f16_gone", lambda: 1)
    reg.unregister("f16_gone")
    return reg


def test_registry_renders_the_same_bytes_as_jax():
    treg, jreg = _fill(tmetrics), _fill(jmetrics)
    assert treg.names() == jreg.names()
    body = treg.render()
    assert body == jreg.render()
    assert tmetrics.validate_exposition(body) == \
        jmetrics.validate_exposition(body) == []
    assert 'f16_labelled{worker="a"} 1.5' in body
    assert "f16_absent" not in body and "f16_raises" not in body
    assert tmetrics.CONTENT_TYPE == jmetrics.CONTENT_TYPE
    assert tmetrics.METRIC_CENSUS == jmetrics.METRIC_CENSUS


@pytest.mark.parametrize("body", [
    "", "# TYPE f16_x gauge\nf16_x 1\n", "f16_x 1\n",
    "# TYPE f16_x gauge\nf16_x{a=1} 1\n", "# TYPE f16_x bogus\nf16_x 1\n",
    "# HELP f16_x\n# TYPE f16_x gauge\nf16_x 1\n",
    "# TYPE f16_x gauge\nf16_x one\n", "# TYPE f16_x gauge\nf16_x 1 2\n",
    '# TYPE f16_x counter\nf16_x{a="1",b="\\"q\\""} 3e-05\n',
])
def test_validate_exposition_agrees_with_jax(body):
    assert tmetrics.validate_exposition(body) == \
        jmetrics.validate_exposition(body)


def _jax_service_names():
    """The series the JAX package's service exporter registers (its SLO
    loop on), read off its ``_make_metrics_server`` with stand-in
    collaborators; the server is closed unserved."""
    fake = types.SimpleNamespace(
        requests=types.SimpleNamespace(depth=lambda: 0),
        batcher=types.SimpleNamespace(inflight=0, quarantined={}),
        latency=None, slo=JSLOMonitor(JSLOConfig()))
    srv = JService._make_metrics_server(fake, 0)
    try:
        return set(srv.registry.names())
    finally:
        srv._httpd.server_close()


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    feats, labels, _ = make_dataset(n_tests=160, seed=7)
    reg = ModelRegistry(str(tmp_path_factory.mktemp("metrics-registry")),
                        device="cpu")
    with jax.enable_x64(False):
        for keys in (DT_CONFIG, ET_CONFIG):
            reg.fit_and_register(keys, feats, labels, max_depth=6,
                                 tree_overrides={"Extra Trees": 4}, seed=3)
    return reg, np.asarray(feats)


def _scrape(port):
    url = f"http://127.0.0.1:{port}/metrics"
    with urllib.request.urlopen(url, timeout=10.0) as resp:
        assert resp.headers["Content-Type"] == tmetrics.CONTENT_TYPE
        return resp.read().decode()


def _typed(body):
    return {line.split()[2] for line in body.splitlines()
            if line.startswith("# TYPE ")}


def test_service_exposition_valid_under_jax(registry, tmp_path):
    reg, feats = registry
    with ScoringService(reg, buckets=(4, 16), device="cpu",
                        slo=SLOConfig(), metrics_port=0) as svc:
        for i, mid in enumerate(reg.ids() * 3):
            svc.score(mid, feats[i:i + 3], kind=("predict", "shap")[i % 2],
                      timeout=60)
        names = set(svc.metrics.registry.names())
        body = _scrape(svc.metrics.port)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{svc.metrics.port}/other", timeout=10.0)
    assert svc.metrics is None                # stopped with the service
    assert jmetrics.validate_exposition(body) == []
    assert tmetrics.validate_exposition(body) == []
    jax_names = set(jmetrics.register_process_sources(
        jmetrics.MetricsRegistry()).names()) | _jax_service_names()
    assert LEFT_OUT <= jax_names
    assert names == jax_names - LEFT_OUT
    assert _typed(body) <= names
    assert "f16_serve_requests_total 6" in body.splitlines()
    assert "f16_slo_shedding 0" in body.splitlines()


def test_process_sources_read_journal_lag_and_counters(tmp_path,
                                                       monkeypatch):
    reg = tmetrics.register_process_sources(tmetrics.MetricsRegistry())
    monkeypatch.setattr(tjournal, "_last_append_ts", None)
    assert tjournal.fold_lag_s() is None
    body = reg.render()
    assert "f16_journal_fold_lag_seconds" not in body
    assert "f16_uptime_seconds" not in body       # telemetry off
    assert "f16_device_mem_peak_mb" not in body   # no CUDA context
    monkeypatch.setattr(tjournal, "_last_append_ts", 100.0)
    assert tjournal.fold_lag_s(now=102.5) == 2.5
    assert tjournal.fold_lag_s(now=99.0) == 0.0
    tobs.configure(root=str(tmp_path), heartbeat_s=0)
    try:
        tobs.counter_add("configs", 3)
        body = reg.render()
    finally:
        tobs.shutdown()
    assert tmetrics.validate_exposition(body) == []
    assert 'f16_events_total{name="configs"} 3' in body
    assert "f16_journal_fold_lag_seconds" in body
    assert "f16_uptime_seconds" in body


def test_journal_append_stamps_fold_lag(tmp_path, monkeypatch):
    monkeypatch.setattr(tjournal, "_last_append_ts", None)
    jr = tjournal.SweepJournal.open(str(tmp_path / "s.journal"), {"a": 1})
    try:
        assert tjournal.fold_lag_s() is not None   # the header append
        assert 0.0 <= tjournal.fold_lag_s() < 60.0
    finally:
        jr.close()


def test_serve_cli_metrics_port(capsys):
    code = serve_main(["--synth", "120", "--trees", "2", "--max-depth",
                       "4", "--requests", "8", "--rows", "4", "--clients",
                       "2", "--buckets", "4,8", "--metrics-port", "0",
                       "--json"], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert code == 0
    port = [ln for ln in lines if ln.startswith("METRICS_PORT ")]
    assert len(port) == 1 and int(port[0].split()[1]) > 0
    stats = json.loads(lines[-1])
    assert stats["n_errors"] == 0 and "slo" in stats  # the SLO rides along
    with pytest.raises(ValueError):
        serve_main(["--metrics-port", "any"], device="cpu")


def _emitted_names():
    """{name: [file:line]} of every literal first argument of a
    ``gauge``/``counter_add`` call in the package (the attribute form
    ``obs.gauge("n", ...)`` and core's own bare ``gauge("n", ...)``)."""
    out = {}
    for root, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as fd:
                tree = ast.parse(fd.read(), path)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                fname = f.attr if isinstance(f, ast.Attribute) else \
                    f.id if isinstance(f, ast.Name) else None
                if fname in ("gauge", "counter_add") and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    out.setdefault(node.args[0].value, []).append(
                        f"{os.path.relpath(path, PKG)}:{node.lineno}")
    return out


def test_metric_census_matches_the_package_both_ways():
    emitted = _emitted_names()
    unregistered = {n: s for n, s in emitted.items()
                    if n not in tmetrics.METRIC_CENSUS}
    assert not unregistered, unregistered
    assert set(emitted) == set(tmetrics.METRIC_CENSUS)
    assert {"serve.requests", "fleet.rps", "configs",
            "shap_configs"} <= set(emitted)
