"""The harness finds what a later change adds as files: a configuration,
a cell and a per-layer metric, with only new files and new entries in
BENCHMARK.json."""

import json
import os
import shutil

import pytest

from port_bench.harness import spec
from port_bench.tests import tiny

NEW_METRIC = '''"""Configs the traced stretch completed (a test's metric)."""


def read(ctx):
    return float(ctx["tracer"].units.get("configs", 0)) or None
'''


def test_new_config_cell_and_metric_are_found(tmp_path):
    root = tiny.make_root(tmp_path)
    bench = os.path.join(root, "port_bench")
    shutil.copy(os.path.join(bench, "configs", "flake16-study.json"),
                os.path.join(bench, "configs", "flake16-small.json"))
    with open(os.path.join(bench, "workloads",
                           "study-scores-hist.json")) as fd:
        workload = json.load(fd)
    workload.update(config="flake16-small", traffic="planner-hist-2")
    workload["params"]["axes"]["model"] = ["Random Forest"]
    with open(os.path.join(bench, "workloads", "study-small.json"),
              "w") as fd:
        json.dump(workload, fd)
    with open(os.path.join(bench, "metrics", "sweep.traced_configs.py"),
              "w") as fd:
        fd.write(NEW_METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as fd:
        b = json.load(fd)
    b["configs"].append(dict(b["configs"][0], name="flake16-small",
                             file="port_bench/configs/flake16-small.json"))
    b["workloads"].append({"name": "study-small", "config": "flake16-small",
                           "traffic": "planner-hist-2", "chips": 1,
                           "why": "a test's cell"})
    for m in b["end_to_end"]:
        if m["name"] == "configs_per_s":
            m["workloads"].append("study-small")
    b["per_layer"].append({"name": "sweep.traced_configs", "unit": "configs",
                           "better": "higher", "source": "program_counter",
                           "layer": "Sweep engine", "moves": "configs_per_s",
                           "workloads": ["study-small"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fd:
        json.dump(b, fd)

    cell = spec.load_cell("study-small", root=root)
    assert cell.config["name"] == "flake16-study"
    assert [m["name"] for m in cell.per_layer] == ["sweep.traced_configs"]
    assert "configs_per_s" in [m["name"] for m in cell.end_to_end]

    out = tiny.execute(root, "study-small", trace=0)
    assert out["correct"] and "configs_per_s" in out["metrics"]
    out = tiny.execute(root, "study-small", trace=1)
    assert out["correct"]
    assert out["metrics"]["sweep.traced_configs"]["value"] == 2.0


def test_missing_files_are_named(tmp_path):
    root = tiny.make_root(tmp_path)
    with pytest.raises(spec.SpecError, match="no workload"):
        spec.load_cell("no-such-cell", root=root)
    os.remove(os.path.join(root, "port_bench", "workloads",
                           "serve-ci-predict.json"))
    with pytest.raises(spec.SpecError, match="serve-ci-predict.json"):
        spec.load_cell("serve-ci-predict", root=root)
    with pytest.raises(spec.SpecError, match="missing"):
        spec.load_module("metrics", "no.such.metric",
                         os.path.join(root, "port_bench"))


def test_every_cell_and_metric_of_the_benchmark_resolves():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as fd:
        b = json.load(fd)
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        spec.load_module("traffic", cell.workload["driver"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.load_module("metrics", m["name"]).read)
