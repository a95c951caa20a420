"""The port's performance database (``obs/perfdb.py``), the ``perf`` verb
(``obs/perf_diff.py``) and the lookups that read it (the planner's
``plan_pad_to``, the plan executor's tuned window width, the service's
warm buckets), against the JAX package's on the same inputs, on the CPU.

Held: the committed ``BENCH_r*.json`` backfilled through each package
into rows equal but for ``ts`` and ``crc``; each package loading (CRCs
verified) and recovering the database the other wrote; ``perf diff r05
r08 --json`` and ``perf sentinel --json`` documents equal; the rows of a
JAX package run directory equal, and a port run's kernel rows carrying
its launch counts; plans and grower keywords equal under recorded rows
(a window width above K1's shared-memory bound sanitized to nothing);
``scores planner`` under a recorded pad and a tuned window width bitwise
equal to the run without them and to the JAX package's; the warm buckets
falling through exactly as the JAX package's do."""

import io
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from flake16_framework_tpu import obs as jobs
from flake16_framework_tpu import pipeline as jpipe
from flake16_framework_tpu.obs import perf_diff as jperf_diff
from flake16_framework_tpu.obs import perfdb as jperfdb
from flake16_framework_tpu.obs import schema as jschema
from flake16_framework_tpu.parallel import planner as jplanner
from flake16_framework_tpu.serve import service as jservice
from flake16_framework_tpu.utils.synth import make_tests_json
from flake16_framework_tpu_torch import __main__ as tmain
from flake16_framework_tpu_torch import obs as tobs
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch.constants import HIST_BINS
from flake16_framework_tpu_torch.kernels import hist as thist
from flake16_framework_tpu_torch.obs import perf_diff as tperf_diff
from flake16_framework_tpu_torch.obs import perfdb as tperfdb
from flake16_framework_tpu_torch.obs import schema as tschema
from flake16_framework_tpu_torch.ops import trees as ttrees
from flake16_framework_tpu_torch.parallel import planner as tplanner
from flake16_framework_tpu_torch.serve import service as tservice

DB = {"jax": jperfdb, "torch": tperfdb}
TINY = {"Extra Trees": 4, "Random Forest": 4}
# Three families, none with PCA, so the scores are held bitwise against
# the JAX package's: an Extra Trees and a Random Forest (hist grower, K1)
# and a Decision Tree (exact grower).
CONFIGS = [
    ("NOD", "Flake16", "None", "None", "Extra Trees"),
    ("OD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
    ("NOD", "Flake16", "Scaling", "None", "Decision Tree"),
]
N_TESTS, N_PROJECTS = 160, 4


@pytest.fixture(autouse=True)
def _no_db(monkeypatch):
    """No database unless a test records one; 64-bit mode off."""
    monkeypatch.setenv("F16_PERFDB", "0")
    for name in ("F16_HIST_NODE_BATCH", "F16_HIST_NODE_BATCH_CPU"):
        monkeypatch.delenv(name, raising=False)
    with jax.enable_x64(False):
        yield


def _bare(rows):
    return [{k: v for k, v in r.items() if k not in ("ts", "crc")}
            for r in rows]


@pytest.fixture(scope="module")
def backfilled(tmp_path_factory):
    """{package: db path} of one backfill of the committed rounds each."""
    d = tmp_path_factory.mktemp("perfdb")
    out = {}
    for pkg, mod in DB.items():
        out[pkg] = str(d / f"{pkg}.jsonl")
        rounds = mod.backfill(path=out[pkg])
        assert rounds and all(n > 0 for n in rounds.values())
    return out


# -- the store: rows, CRCs, recovery --------------------------------------


def test_backfill_rows_equal_jax(backfilled):
    rows = {pkg: DB[pkg].load(p) for pkg, p in backfilled.items()}
    assert rows["torch"] and _bare(rows["torch"]) == _bare(rows["jax"])
    for row in rows["torch"]:
        assert tschema.validate_perfdb_row(row) == []
        assert jschema.validate_perfdb_row(row) == []
    assert tperfdb.committed_rounds() == jperfdb.committed_rounds()
    # idempotent: a second backfill appends nothing
    assert sum(tperfdb.backfill(path=backfilled["torch"]).values()) == 0


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_each_package_loads_and_recovers_the_others(tmp_path, writer,
                                                    reader):
    db = str(tmp_path / "perfdb.jsonl")
    rows = [DB[writer].make_row("cuda", "t", f"k{i}", {"wall_s": i + 1.0},
                                knobs={"F16_X": str(i)}, src=f"s{i}")
            for i in range(3)]
    assert DB[writer].append(rows, path=db) == 3
    got = DB[reader].load(db)                 # CRCs verified per line
    assert got == rows
    with open(db, "ab") as fd:
        fd.write(b'{"schema": "flake16-perfdb-v1", "torn mid-wri')
    assert DB[reader].recover(db)[0] == 3
    assert DB[writer].load(db) == rows
    # a tampered row (its CRC stale) is skipped by either reader
    with open(db, "a") as fd:
        fd.write(json.dumps(dict(rows[0], src="tampered")) + "\n")
    assert DB[reader].load(db) == DB[writer].load(db) == rows
    # the reader appends behind the writer's rows, deduped by identity
    assert DB[reader].append(rows[:1], path=db) == 0


def test_schema_constants_and_validation_match_jax():
    assert tschema.PERFDB_SCHEMA == jschema.PERFDB_SCHEMA
    assert tschema.LOCKWATCH_SCHEMA == jschema.LOCKWATCH_SCHEMA
    assert tschema.PERFDB_ROW_FIELDS == jschema.PERFDB_ROW_FIELDS
    assert tschema.EVENT_FIELDS["perf"] == jschema.EVENT_FIELDS["perf"]
    row = tperfdb.make_row("cuda", "t", "k", {"wall_s": 1.0})
    for bad in ({}, dict(row, schema="flake16-perfdb-v0"),
                dict(row, knobs=[1]), dict(row, metrics={"wall_s": "x"}),
                dict(row, backend=3), "row"):
        assert tschema.validate_perfdb_row(bad) == \
            jschema.validate_perfdb_row(bad) != []
    assert tschema.validate_perfdb_row(row) == []


# -- the perf verb ---------------------------------------------------------


@pytest.mark.parametrize("args", [
    ["diff", "r05", "r08", "--json"],
    ["diff", "r01", "r10", "--json", "--top", "3"],
    ["sentinel", "--json"],
    ["sentinel", "--json", "--threshold", "5"],
])
def test_perf_documents_equal_jax(args, tmp_path):
    db = ["--db", str(tmp_path / "empty.jsonl")]
    outs = {}
    for pkg, mod in (("torch", tperf_diff), ("jax", jperf_diff)):
        buf = io.StringIO()
        mod.perf_main(args + db, out=buf)
        outs[pkg] = buf.getvalue()
    assert outs["torch"] == outs["jax"]
    doc = json.loads(outs["torch"])
    if args[0] == "diff":
        assert doc["entries"]
    else:
        assert doc["n_series"] > 0 and doc["steps"]
        if "--threshold" not in args:      # the committed history passes
            assert doc["latest_regressions"] == []


def test_perf_diff_text_and_perfetto_equal_jax(tmp_path):
    texts = {}
    for pkg, mod in (("torch", tperf_diff), ("jax", jperf_diff)):
        buf = io.StringIO()
        trace = str(tmp_path / f"{pkg}.json")
        mod.perf_main(["diff", "r05", "r08", "--perfetto", trace], out=buf)
        texts[pkg] = buf.getvalue().replace(trace, "TRACE")
        with open(trace) as fd:
            texts[pkg + "-trace"] = json.load(fd)
    assert texts["torch"] == texts["jax"]
    assert texts["torch-trace"] == texts["jax-trace"]
    assert "fit" in texts["torch"] and "regressed" in texts["torch"]


def test_perf_cli_ingest_lookup_backfill(tmp_path, capsys):
    db = str(tmp_path / "perfdb.jsonl")
    audit = {"schema": jschema.AUDIT_SCHEMA, "backend": "cpu",
             "envelopes": [{"entry": "sweep.fit", "peak_mb": 12.5,
                            "arg_bytes": 1e6, "out_bytes": 2e6}]}
    path = str(tmp_path / "audit.json")
    with open(path, "w") as fd:
        json.dump(audit, fd)
    tmain.main(["perf", "ingest", path, "--db", db])
    assert "1 new row(s)" in capsys.readouterr().out
    (row,) = tperfdb.load(db)
    assert _bare([row]) == _bare(jperfdb.rows_from_path(path))
    tperfdb.record_tuned("cuda", "sig", "fit", {"plan_pad_to": 4},
                         {"fit_s": 1.0}, path=db)
    tmain.main(["perf", "lookup", "cuda", "sig", "fit", "--db", db,
                "--json"])
    assert json.loads(capsys.readouterr().out)["knobs"] == \
        {"plan_pad_to": 4}
    tmain.main(["perf", "lookup", "cpu", "sig", "--db", db])
    assert "fall through" in capsys.readouterr().out
    tmain.main(["perf", "backfill", "--db", db, "--json"])
    payload = json.loads(capsys.readouterr().out)
    assert payload["new_rows"] > 0 and payload["db"] == db
    with pytest.raises(ValueError, match="subcommand"):
        tmain.main(["perf"])
    with pytest.raises(ValueError, match="Unrecognized perf subcommand"):
        tmain.main(["perf", "tune"])
    with pytest.raises(SystemExit, match="neither a committed bench"):
        tmain.main(["perf", "diff", "r05", "r99"])


# -- telemetry runs --------------------------------------------------------


def test_rows_from_a_jax_run_equal_jax(tmp_path):
    """A JAX package run directory (its ``cost`` events and stage spans)
    yields the JAX package's rows."""
    run_dir = jobs.configure(root=str(tmp_path), heartbeat_s=0)
    try:
        for cfg, wall in (("A", 2.0), ("B", 1.0)):
            jobs.event("span", name="scores.fit", wall_s=wall, cold=False,
                       stage="fit", config=cfg)
        jobs.event("span", name="scores.score", wall_s=0.5, cold=False,
                   stage="predict", configs=["A", "B"])
        jobs.event("cost", span="scores.plan_batch", flops=1e9,
                   bytes=2e8, compile_s=1.5, lower_s=0.2)
        jobs.manifest_update(backend="cpu")
    finally:
        jobs.shutdown()
    want = jperfdb.rows_from_run(run_dir)
    got = tperfdb.rows_from_run(run_dir)
    assert got and _bare(got) == _bare(want)
    assert {r["kernel"] for r in got} >= {"stage.fit", "stage.predict",
                                          "kernel.scores.plan_batch"}


def test_rows_from_a_port_run_carry_launches(tmp_path):
    """A port run's kernel rows come from its spans' launch counts: one
    ``kernel.hist_cumsum`` and one ``kernel.treeshap_unit`` row, ``n``
    the launches, backend the manifest's device type; and from its
    entry points' ``cost`` events (``obs/costs.py``): one
    ``kernel.<span>`` row each, as from a JAX package run."""
    from flake16_framework_tpu_torch.obs import costs

    counts = {"k1_launches": 0, "k2_launches": 0}

    def launches():
        return dict(counts)

    fit = costs.instrument(lambda x: x @ x.T, "scores.fit")
    run_dir = tobs.configure(root=str(tmp_path), heartbeat_s=0)
    try:
        tobs.manifest_update(backend="cuda")
        for fold in range(3):
            with tobs.span("scores.fit", key="rf", counts=launches,
                           stage="fit", config="A", fold=fold):
                fit(torch.ones((4, 8)))
                counts["k1_launches"] += 30 + fold
        with tobs.span("shap.config", key="et", counts=launches,
                       stage="shap", config="B"):
            counts["k1_launches"] += 7
            counts["k2_launches"] += 4
    finally:
        tobs.shutdown()
    rows = {r["kernel"]: r for r in tperfdb.rows_from_run(run_dir)}
    assert rows["kernel.hist_cumsum"]["metrics"] == {"n": 100.0}
    assert rows["kernel.treeshap_unit"]["metrics"] == {"n": 4.0}
    assert {r["backend"] for r in rows.values()} == {"cuda"}
    assert set(rows["stage.fit"]["metrics"]) == {"wall_s"}
    # one counting pass (the first fold's signature): 2 * 4 * 8 * 4 flops;
    # bytes of every aten op's operands and output: the transpose (128 B
    # in, 128 B out) and the product (two 128 B operands, 64 B out)
    assert rows["kernel.scores.fit"]["metrics"] == {
        "flops": 256.0, "bytes": 576.0, "compile_s": 0.0, "n": 1.0}
    # the JAX package reads the same run: the same cost row, and no
    # launch rows (the JAX package's spans carry no launch counts)
    jrows = {r["kernel"] for r in jperfdb.rows_from_run(run_dir)}
    assert jrows == set(rows) - {"kernel.hist_cumsum",
                                 "kernel.treeshap_unit"}
    # through the verb, into a database either package reads
    db = str(tmp_path / "perfdb.jsonl")
    tperf_diff.perf_main(["ingest", run_dir, "--db", db], out=io.StringIO())
    assert _bare(jperfdb.load(db)) == _bare(tperfdb.load(db)) != []


# -- lookups: plans, grower keywords, warm buckets ------------------------


def _shape(model, n=240):
    return tplanner.plan_shape("Flake16", model, n=n, n_folds=10,
                               tree_overrides=TINY)


@pytest.mark.parametrize("pad,devices", [
    (4, 1), (4, 2), (0, 1), (-4, 1), ("x", 1), (None, 1), (3, 2), (8, 8),
])
def test_plan_grid_under_recorded_pad_equals_jax(tmp_path, pad, devices):
    db = str(tmp_path / "perfdb.jsonl")
    configs = [c for c in CONFIGS] + [
        ("OD", "Flake16", "None", "None", "Decision Tree")]
    for model in ("Decision Tree", "Extra Trees"):
        tperfdb.record_tuned("cpu", tperfdb.shape_sig(_shape(model)), "fit",
                             {"plan_pad_to": pad}, {"fit_s": 1.0}, path=db)
    plans = {}
    for pkg, pl, mod in (("torch", tplanner, tperfdb),
                         ("jax", jplanner, jperfdb)):
        plans[pkg] = [(p.family, p.configs, p.shape, p.batch, p.pad,
                       p.mask) for p in pl.plan_grid(
            configs, devices=devices, n=240, n_folds=10,
            tree_overrides=TINY, perf_lookup=mod.plan_lookup("cpu", path=db))]
    assert plans["torch"] == plans["jax"]
    base = tplanner.plan_grid(configs, devices=devices, n=240, n_folds=10,
                              tree_overrides=TINY, perf_lookup=None)
    valid = isinstance(pad, int) and pad > 0 and pad % devices == 0
    for p, b in zip(plans["torch"], base):
        if valid:               # RF shares ET's plan shape, and its row
            assert p[3] % pad == 0 and p[3] >= b.batch
        else:
            assert p[3] == b.batch
    assert tperfdb.plan_lookup("cpu", path=str(tmp_path / "no.jsonl")) \
        is None


@pytest.mark.parametrize("knobs,want", [
    ({"F16_HIST_NODE_BATCH": "64"}, {"node_batch": 64}),
    ({"F16_HIST_NODE_BATCH_CPU": "16", "F16_HIST_NODE_BATCH": "64"},
     {"node_batch": 16}),
    ({"F16_HIST_NODE_BATCH": "1"}, {"node_batch": 1}),
    ({"F16_HIST_NODE_BATCH": "226"}, {"node_batch": 226}),
    ({"F16_HIST_NODE_BATCH": "227"}, {}),        # beyond K1's smem bound
    ({"F16_HIST_NODE_BATCH": "256"}, {}),        # a JAX tuner's width
    ({"F16_HIST_NODE_BATCH": "4096"}, {}),
    ({"F16_HIST_NODE_BATCH": "0"}, {}),
    ({"F16_HIST_NODE_BATCH": "wide"}, {}),
    ({"F16_HIST_REFINE_TILE": "512"}, {}),       # no refinement tile here
    ({"F16_HIST_REFINE_TILE": "512", "F16_HIST_NODE_BATCH": "32"},
     {"node_batch": 32}),
    # a parity-affecting knob never reaches a plan from a tuned row
    ({"F16_HIST_BINS": "32"}, {}),
    ({"F16_HIST_BINS": "48", "F16_HIST_NODE_BATCH": "64"},
     {"node_batch": 64}),
])
def test_tuned_fit_overrides_against_jax(tmp_path, knobs, want):
    db = str(tmp_path / "perfdb.jsonl")
    shape = _shape("Extra Trees")
    tperfdb.record_tuned("cpu", tperfdb.shape_sig(shape),
                         tperfdb.model_kernel("Extra Trees"), knobs,
                         {"fit_s": 1.0}, path=db)
    got = tperfdb.tuned_fit_overrides("cpu", shape, model="Extra Trees",
                                      path=db, env={})
    jgot = jperfdb.tuned_fit_overrides("cpu", shape, model="Extra Trees",
                                       path=db, env={})
    assert got == want
    # the JAX package's answer, less refine_tile and less widths that
    # exceed K1's shared memory
    limit = thist.max_window(HIST_BINS)
    assert got == {k: v for k, v in jgot.items()
                   if k == "node_batch" and v <= limit}
    # env pins outrank the row, as in the JAX package; other keys, other
    # models and other backends fall through
    for env in ({"F16_HIST_NODE_BATCH": "8"},
                {"F16_HIST_NODE_BATCH_CPU": "8"}):
        assert tperfdb.tuned_fit_overrides(
            "cpu", shape, model="Extra Trees", path=db, env=env) == {}
    assert tperfdb.tuned_fit_overrides("cuda", shape, model="Extra Trees",
                                       path=db, env={}) == {}
    assert tperfdb.tuned_fit_overrides("cpu", shape, model="Random Forest",
                                       path=db, env={}) == {}


def test_k1_window_bound():
    limit = thist.max_window(HIST_BINS)
    assert thist.smem_bytes(limit, HIST_BINS) <= thist._SMEM_LIMIT \
        < thist.smem_bytes(limit + 1, HIST_BINS)
    assert limit >= ttrees.NODE_BATCH["cuda"]


@pytest.mark.parametrize("bins,width,want", [
    ("32", "226", {"node_batch": 226}),
    ("128", "113", {"node_batch": 113}),
    ("128", "114", {}),                          # past K1's window at 128
    ("256", "64", {}),                           # 56 nodes at 256
])
def test_tuned_width_bound_follows_the_exported_bins(tmp_path, monkeypatch,
                                                     bins, width, want):
    db = str(tmp_path / "perfdb.jsonl")
    shape = _shape("Random Forest")
    tperfdb.record_tuned("cpu", tperfdb.shape_sig(shape),
                         tperfdb.model_kernel("Random Forest"),
                         {"F16_HIST_NODE_BATCH": width}, {"fit_s": 1.0},
                         path=db)
    monkeypatch.setenv("F16_HIST_BINS", bins)
    assert tperfdb.tuned_fit_overrides("cpu", shape, model="Random Forest",
                                       path=db, env={}) == want


@pytest.fixture(scope="module")
def tests_json(tmp_path_factory):
    tj = str(tmp_path_factory.mktemp("perfdb-scores") / "tests.json")
    make_tests_json(tj, n_tests=N_TESTS, n_projects=N_PROJECTS, seed=3)
    return tj


def _record_plan_rows(db, width):
    """A recorded pad for every family and a tuned window width for the
    hist families, at the plan shapes of ``CONFIGS``."""
    for keys in CONFIGS:
        shape = _shape(keys[4], n=N_TESTS)
        sig = tperfdb.shape_sig(shape)
        tperfdb.record_tuned("cpu", sig, "fit", {"plan_pad_to": 2},
                             {"fit_s": 1.0}, path=db)
        if keys[4] != "Decision Tree":
            tperfdb.record_tuned(
                "cpu", sig, tperfdb.model_kernel(keys[4]),
                {"F16_HIST_NODE_BATCH": str(width)}, {"fit_s": 0.5},
                path=db)


def test_scores_planner_unchanged_by_recorded_rows(tests_json, tmp_path,
                                                   monkeypatch):
    """``scores planner`` with a recorded pad and a tuned window width
    gives scores bitwise equal to the run without a database and to the
    JAX package's ``write_scores`` under the same database; the width
    reached the hist grower (and only it)."""
    kw = dict(configs=CONFIGS, max_depth=8, tree_overrides=TINY,
              planner=True, progress_out=io.StringIO())
    widths = []
    real = ttrees._grow_trees

    def grow(*a, **k):
        widths.append(k["node_batch"])
        return real(*a, **k)

    monkeypatch.setattr(ttrees, "_grow_trees", grow)
    base = tpipe.write_scores(tests_json, str(tmp_path / "base.pkl"),
                              device="cpu", **kw)
    assert set(widths) == {ttrees.NODE_BATCH["cpu"]}

    db = str(tmp_path / "perfdb.jsonl")
    _record_plan_rows(db, 64)
    monkeypatch.setenv("F16_PERFDB", db)
    widths.clear()
    got = tpipe.write_scores(tests_json, str(tmp_path / "t.pkl"),
                             device="cpu", **kw)
    assert set(widths) == {64}
    assert pickle.dumps({k: v[2:] for k, v in got.items()}) == \
        pickle.dumps({k: v[2:] for k, v in base.items()})
    one = Mesh(np.array(jax.devices()[:1]), ("config",))
    want = jpipe.write_scores(tests_json, str(tmp_path / "j.pkl"),
                              journal=False, mesh=one, **kw)
    for k in CONFIGS:
        assert got[k][2:] == want[k][2:], k
    # a width beyond K1's bound falls through to the default width
    db2 = str(tmp_path / "wide.jsonl")
    _record_plan_rows(db2, 4096)
    monkeypatch.setenv("F16_PERFDB", db2)
    widths.clear()
    again = tpipe.write_scores(tests_json, str(tmp_path / "w.pkl"),
                               device="cpu", **dict(kw, configs=CONFIGS[:1]))
    assert set(widths) == {ttrees.NODE_BATCH["cpu"]}
    assert again[CONFIGS[0]][2:] == base[CONFIGS[0]][2:]


@pytest.mark.parametrize("device_type,env,want", [
    ("cpu", {}, 8),
    ("cuda", {}, 128),
    ("cpu", {"F16_HIST_NODE_BATCH_CPU": "0"}, 8),     # the JAX "auto"
    ("cpu", {"F16_HIST_NODE_BATCH_CPU": "16"}, 16),
    ("cpu", {"F16_HIST_NODE_BATCH": "64"}, 8),        # the card's pin
    ("cuda", {"F16_HIST_NODE_BATCH": "64"}, 64),
    ("cuda", {"F16_HIST_NODE_BATCH": "226"}, 226),
    ("cuda", {"F16_HIST_NODE_BATCH_CPU": "16"}, 128),
    ("cuda", {"F16_HIST_NODE_BATCH": "227"}, None),   # beyond K1's bound
    ("cuda", {"F16_HIST_NODE_BATCH": "0"}, None),
    ("cpu", {"F16_HIST_NODE_BATCH_CPU": "wide"}, None),
])
def test_default_node_batch_pins(device_type, env, want):
    if want is None:
        with pytest.raises(ValueError, match="F16_HIST_NODE_BATCH"):
            ttrees.default_node_batch(device_type, env=env)
    else:
        assert ttrees.default_node_batch(device_type, env=env) == want


def test_node_batch_pin_outranks_the_row_in_the_grower(tests_json,
                                                       tmp_path,
                                                       monkeypatch):
    """An operator's ``F16_HIST_NODE_BATCH_CPU`` reaches the hist grower
    of ``scores planner`` over a tuned row of another width, and leaves
    the scores as they are."""
    kw = dict(configs=CONFIGS[:1], max_depth=8, tree_overrides=TINY,
              planner=True, progress_out=io.StringIO(), device="cpu")
    widths = []
    real = ttrees._grow_trees

    def grow(*a, **k):
        widths.append(k["node_batch"])
        return real(*a, **k)

    monkeypatch.setattr(ttrees, "_grow_trees", grow)
    base = tpipe.write_scores(tests_json, str(tmp_path / "base.pkl"), **kw)
    db = str(tmp_path / "perfdb.jsonl")
    _record_plan_rows(db, 64)
    monkeypatch.setenv("F16_PERFDB", db)
    monkeypatch.setenv("F16_HIST_NODE_BATCH_CPU", "16")
    widths.clear()
    got = tpipe.write_scores(tests_json, str(tmp_path / "pin.pkl"), **kw)
    assert set(widths) == {16}
    assert got[CONFIGS[0]][2:] == base[CONFIGS[0]][2:]


def test_resolve_buckets_falls_through_as_jax(tmp_path, monkeypatch):
    def both(buckets=None):
        got = tservice.resolve_buckets(buckets, "cpu")
        assert got == jservice.resolve_buckets(buckets)
        return got

    assert tservice.DEFAULT_BUCKETS == jservice.DEFAULT_BUCKETS
    assert both() == tservice.DEFAULT_BUCKETS            # F16_PERFDB=0
    monkeypatch.setenv("F16_PERFDB", str(tmp_path / "absent.jsonl"))
    assert both() == tservice.DEFAULT_BUCKETS            # no database
    db = str(tmp_path / "perfdb.jsonl")
    tperfdb.record_tuned("cpu", "other", "serve", {"serve_buckets": [4]},
                         {"p99_ms": 1.0}, path=db)
    monkeypatch.setenv("F16_PERFDB", db)
    assert both() == tservice.DEFAULT_BUCKETS            # no serve row
    tperfdb.record_tuned("*", "serve", "serve", {"serve_buckets": [64, 16]},
                         {"p99_ms": 1.0}, path=db)
    assert both() == (16, 64)                            # recorded ladder
    assert both((64, 2)) == (2, 64)                      # explicit wins
    assert tservice.resolve_buckets(None, "cuda") == (16, 64)
    for bad in ([0, -2], [], "8,32", ["x"], None):
        p = str(tmp_path / f"bad-{bad!r}.jsonl")
        tperfdb.record_tuned("*", "serve", "serve", {"serve_buckets": bad},
                             {"p99_ms": 1.0}, path=p)
        monkeypatch.setenv("F16_PERFDB", p)
        assert both() == tservice.DEFAULT_BUCKETS        # malformed knob
    # a backend-specific row answers only its backend
    p = str(tmp_path / "cuda.jsonl")
    tperfdb.record_tuned("cuda", "serve", "serve", {"serve_buckets": [16]},
                         {"p99_ms": 1.0}, path=p)
    monkeypatch.setenv("F16_PERFDB", p)
    assert tservice.resolve_buckets(None, "cuda") == (16,)
    assert both() == tservice.DEFAULT_BUCKETS


def test_current_backend_never_initializes_cuda(monkeypatch):
    """The backend the consults default to is the torch device type of
    this process's context, read without creating one."""
    import torch

    assert tperfdb._current_backend() == (
        "cuda" if torch.cuda.is_initialized() else "cpu")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert tperfdb._current_backend() == "cuda"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert tperfdb._current_backend() == "cpu"
    assert os.environ["F16_PERFDB"] == "0"
    assert tperfdb.default_db() is None and tperfdb.serve_buckets() is None
