"""The port's ``report`` and ``trace`` verbs against the JAX package's, on
the CPU, over run directories of both packages: the same tiny ``scores``
run (two Decision Tree configs and a 3-tree Random Forest, N = 120 over 4
projects, depth 8) with telemetry on in each package.

Each package's ``report --json`` document (``summarize``) on the other
package's run equals that package's own on it, and validates under both
packages' ``validate_report``; each package's ``trace`` gives the same
Chrome-trace events on either run. ``--attrib`` ranks the port run's
configs by wall, with their stages, the fit split into the grower's
sub-stages by the port's own ``cost`` events (``obs/costs.py``), and
joins the spans' kernel launch counts. The end-to-end test follows the
JAX package's ``tests/test_obs.py::test_scores_run_is_reportable_end_to_
end``; its ``jax_cache_*`` manifest fields count the port's kernel build
cache, and the port's manifest names ``kernel_build_dir`` where the JAX
package's names ``jax_cache_dir``."""

import gzip
import io
import json
import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from flake16_framework_tpu import pipeline as jpipe
from flake16_framework_tpu.obs import report as jreport
from flake16_framework_tpu.obs import schema as jschema
from flake16_framework_tpu.obs import trace as jtrace
from flake16_framework_tpu_torch import __main__ as tmain
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch.obs import report as treport
from flake16_framework_tpu_torch.obs import schema as tschema
from flake16_framework_tpu_torch.obs import trace as ttrace
from flake16_framework_tpu_torch.utils.synth import make_tests_json
from torch_obs_cases import observed

CONFIGS = [
    ("NOD", "Flake16", "None", "None", "Decision Tree"),
    ("OD", "Flake16", "Scaling", "SMOTE", "Decision Tree"),
    ("NOD", "Flake16", "None", "SMOTE", "Random Forest"),
]
KW = dict(configs=CONFIGS, max_depth=8, tree_overrides={"Random Forest": 3},
          progress_out=io.StringIO())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": run dir, "torch": run dir} of the same scores sweep."""
    d = tmp_path_factory.mktemp("obs-report")
    tj = str(d / "tests.json")
    make_tests_json(tj, n_tests=120, n_projects=4, seed=5)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        with jax.enable_x64(False):
            with observed("jax", d / "jax", mp) as r:
                jpipe.write_scores(tj, str(d / "j.pkl"), mesh=Mesh(
                    np.array(jax.devices()[:1]), ("config",)), **KW)
            out["jax"] = r[0].dir
        with observed("torch", d / "torch", mp) as r:
            tpipe.write_scores(tj, str(d / "t.pkl"), device="cpu", **KW)
        out["torch"] = r[0].dir
    finally:
        mp.undo()
    return out


def _canon(obj):
    return json.loads(json.dumps(obj, default=str))


@pytest.mark.parametrize("run", ["jax", "torch"])
def test_report_json_same_across_packages(runs, run):
    want = _canon(jreport.summarize(*jreport.load_run(runs[run])))
    got = _canon(treport.summarize(*treport.load_run(runs[run])))
    assert got == want
    assert tschema.validate_report(got) == []
    assert jschema.validate_report(got) == []
    buf, jbuf = io.StringIO(), io.StringIO()
    treport.report_main([runs[run], "--json"], out=buf)
    jreport.report_main([runs[run], "--json"], out=jbuf)
    assert json.loads(buf.getvalue()) == json.loads(jbuf.getvalue())


@pytest.mark.parametrize("run", ["jax", "torch"])
def test_trace_same_across_packages(runs, run, tmp_path):
    manifest, events = treport.load_run(runs[run])
    assert ttrace.chrome_trace(manifest, events) == \
        jtrace.chrome_trace(manifest, events)
    path = ttrace.trace_main([runs[run], "--out", str(tmp_path / "t.json")],
                             out=io.StringIO())
    jpath = jtrace.trace_main([runs[run], "--out", str(tmp_path / "j.json")],
                              out=io.StringIO())
    with open(path) as a, open(jpath) as b:
        assert json.load(a)["traceEvents"] == json.load(b)["traceEvents"]


def test_attrib_ranks_the_port_run(runs):
    manifest, events = treport.load_run(runs["torch"])
    at = treport.summarize_attrib(manifest, events)
    assert list(at["configs"]) == sorted(
        at["configs"], key=lambda c: (-at["configs"][c]["total_s"], c))
    assert set(at["configs"]) == {"/".join(k) for k in CONFIGS}
    sub = ("fit.bin", "fit.hist_build", "fit.split_scan", "fit.partition")
    for st in at["configs"].values():
        # (fit.bin's share, one binning against every step, may round
        # to 0 s at the report's 4 decimals)
        assert all(st[s] >= 0 for s in sub) and st["fit.hist_build"] > 0
        assert st["predict"] > 0 and st["total_s"] > 0
    assert set(at["stages"]) == {*sub, "predict"}
    # one cost event a family and entry: the Random Forest's fit carries
    # the stage flops that split every config's fit wall. FlopCounterMode
    # counts contractions only: the plain K1's einsum on the CPU, no op of
    # the exact grower or of predict.
    assert set(at["kernel_costs"]) == {"scores.fit", "scores.score"}
    assert all(k["n"] == 2 and k["bytes"] > 0
               for k in at["kernel_costs"].values())
    assert at["kernel_costs"]["scores.fit"]["flops"] > 0
    assert at["kernel_launches"] == {} and at["kernel_launch_totals"] == {}
    text = treport.render_attrib(at)
    assert "per-config stage attribution" in text
    # the JAX package's view of the same run: the same walls and stages
    jat = jreport.summarize_attrib(manifest, events)
    assert jat["configs"] == at["configs"] and jat["stages"] == at["stages"]


def test_attrib_joins_kernel_launches():
    """Launch fields of fit and explain spans sum per config; a batch
    span's launches split over its members like its wall."""
    ev = [
        {"kind": "span", "name": "scores.fit", "wall_s": 2.0, "ts": 1.0,
         "stage": "fit", "config": "A", "k1_launches": 30,
         "k2_launches": 0},
        {"kind": "span", "name": "scores.fit", "wall_s": 1.0, "ts": 2.0,
         "stage": "fit", "config": "A", "k1_launches": 31,
         "k2_launches": 0},
        {"kind": "span", "name": "scores.plan", "wall_s": 4.0, "ts": 3.0,
         "stage": "plan", "configs": ["B", "C"], "k1_launches": 40,
         "k2_launches": 0},
        {"kind": "span", "name": "shap.config", "wall_s": 1.5, "ts": 4.0,
         "stage": "shap", "config": "D", "fit_s": 1.0, "explain_s": 0.5,
         "k1_launches": 7, "k2_launches": 4},
    ]
    at = treport.summarize_attrib({"run": "r"}, ev)
    assert at["kernel_launches"] == {
        "B": {"hist_cumsum": 20.0}, "C": {"hist_cumsum": 20.0},
        "A": {"hist_cumsum": 61.0},
        "D": {"hist_cumsum": 7.0, "treeshap_unit": 4.0}}
    assert at["kernel_launch_totals"] == {"hist_cumsum": 108.0,
                                          "treeshap_unit": 4.0}
    assert list(at["configs"]) == ["A", "B", "C", "D"]
    assert at["configs"]["D"] == {"fit": 1.0, "shap": 0.5, "total_s": 1.5}
    text = treport.render_attrib(at)
    assert "hist_cumsum = K1" in text and "treeshap_unit" in text
    assert "no cost events" in text


def test_scores_run_is_reportable_end_to_end(runs, tmp_path):
    """A fresh port ``scores`` run with telemetry on yields a report with
    per-stage walls, configs/s and the memory peak, every event valid,
    and a trace holding every span."""
    run_dir = treport.find_run_dir(os.path.dirname(runs["torch"]))
    assert run_dir == runs["torch"]
    manifest, events = treport.load_run(run_dir)
    assert all(tschema.validate_event(e) == [] for e in events)
    rep = treport.summarize(manifest, events)
    assert manifest["verb"] == "scores" and manifest["backend"] == "cpu"
    assert manifest["device_kind"] == "cpu" and "torch_version" in manifest
    assert rep["counters"]["configs"] == 3
    assert rep["throughput_per_s"]["configs"] > 0
    assert {"scores.run_grid", "scores.fit", "scores.score"} <= set(
        rep["spans"])
    assert rep["gauges"]["host_rss_peak_mb"]["peak"] > 0
    # cost events: every entry point's first signature reported nonzero
    # flops and a build wall (obs.costs.instrument's counting pass)
    costs = [e for e in events if e["kind"] == "cost"]
    assert costs, "no cost events: the instrumented dispatch never fired"
    assert any(e["flops"] > 0 for e in costs), costs
    assert all(e["compile_s"] >= 0 and e["bytes"] >= 0 for e in costs)
    assert any(e["span"].startswith("scores.") for e in costs)
    assert manifest["kernel_build_dir"].endswith("_build")
    assert manifest["jax_cache_hits"] >= 0
    assert manifest["jax_cache_misses"] >= 0
    text = treport.render(rep)
    assert "compile_s" in text and "execute_s" in text
    assert "torch_version=" in text
    out_path = ttrace.trace_main([run_dir, "--out", str(tmp_path / "t.json")],
                                 out=io.StringIO())
    with open(out_path) as fd:
        tr = json.load(fd)
    xs = [t for t in tr["traceEvents"] if t.get("ph") == "X"]
    spans = [e for e in events if e["kind"] == "span"]
    assert len(xs) == len(spans)
    assert {x["name"] for x in xs} == {e["name"] for e in spans}
    assert any(t.get("cat") == "journal" for t in tr["traceEvents"])


def test_cli_report_and_trace(runs, capsys):
    root = os.path.dirname(runs["torch"])
    tmain.main(["report", "--root", root])
    assert "scores.fit" in capsys.readouterr().out
    tmain.main(["report", runs["torch"], "--attrib", "--top", "1"])
    assert "more configs" in capsys.readouterr().out
    tmain.main(["trace", runs["torch"]])
    assert os.path.exists(os.path.join(runs["torch"], "trace.json"))
    with pytest.raises(ValueError, match="Unrecognized report option"):
        tmain.main(["report", "--bogus"])
    with pytest.raises(ValueError, match="Unrecognized trace option"):
        tmain.main(["trace", "--bogus"])


def test_report_flight(tmp_path, monkeypatch):
    """``report --flight`` replays a port run's ring as the JAX package's
    does."""
    from flake16_framework_tpu_torch import obs

    monkeypatch.setenv("F16_FLIGHT", "1")
    run_dir = obs.configure(root=str(tmp_path), heartbeat_s=0)
    obs.counter_add("configs", 2)
    obs.gauge("serve.p99_ms", 3.5)
    obs.shutdown()
    got = treport.report_main([run_dir, "--flight"], out=io.StringIO())
    want = jreport.report_main([run_dir, "--flight"], out=io.StringIO())
    assert got["records"] == want["records"]
    assert [r["kind"] for r in got["records"]] == ["flight", "counter",
                                                   "gauge"]


def _kernel_trace(path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "hist_cumsum_kernel<4>",
         "dur": 10.0, "ts": 0},
        {"ph": "X", "cat": "kernel", "name": "hist_cumsum_kernel<4>",
         "dur": 12.0, "ts": 20},
        {"ph": "X", "cat": "kernel", "name": "treeshap_unit_kernel<3>",
         "dur": 5.0, "ts": 40},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 99.0,
         "ts": 50},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "dur": 3.0,
         "ts": 60},
    ]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as fd:
        json.dump({"traceEvents": events}, fd)


@pytest.mark.parametrize("name", ["a.pt.trace.json", "b.trace.json.gz"])
def test_summarize_device_trace_counts_kernels(tmp_path, name):
    _kernel_trace(str(tmp_path / name))
    got = ttrace.summarize_device_trace(str(tmp_path), out=io.StringIO())
    assert got["counts"] == {"hist_cumsum_kernel<4>": 2,
                             "treeshap_unit_kernel<3>": 1}
    assert got["slices"] == 3
    assert got["total_s"] == pytest.approx(27e-6)
    assert got["top"][0]["name"] == "hist_cumsum_kernel<4>"
    assert ttrace.summarize_device_trace(str(tmp_path / "none"),
                                         out=io.StringIO()) is None
