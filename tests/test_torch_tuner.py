"""The port's autotuner (``perf/tuner.py``, the ``tune`` verb) against the
JAX package's ``perf/tuner.py`` on the same inputs, on the CPU.

The JAX registry also holds knobs the port has no reader for
(``F16_HIST_REFINE_TILE``, ``F16_SHAP_TREE_CHUNK``), so the JAX side runs
with its KNOBSPACE cut to the knobs both read (the two window widths and
the parity-affecting ``F16_HIST_BINS``) over the values the port
registers (its card width stops at 128, inside K1's window); the parity
loop runs on ``F16_HIST_BINS`` in both. Held: the registry against the lint's
census; the candidate field and the env-pin precedence; the perfdb
seeding (history walls, audit envelope, memory veto); successive
halving, the compose rung and ``tune_family`` driven by one
deterministic oracle (walls table, winner, rejections, gain, and the
recorded ``tuned`` row field for field, its CRC too once ``ts`` is
pinned); the card widths inside K1's window; ``tune`` refusing to search the CPU without
being asked; the import contract; one real probe child on the CPU."""

import io
import json
import os
import subprocess
import sys
import time

import jax
import pytest

from flake16_framework_tpu.obs import perfdb as jperfdb
from flake16_framework_tpu.perf import tuner as jtuner
from flake16_framework_tpu_torch.analysis import rules_grid
from flake16_framework_tpu_torch.obs import perfdb
from flake16_framework_tpu_torch.parallel import planner
from flake16_framework_tpu_torch.perf import tuner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RF, ET, DT = "Random Forest", "Extra Trees", "Decision Tree"
FS = "Flake16"
SHARED = ("F16_HIST_NODE_BATCH_CPU", "F16_HIST_NODE_BATCH", "F16_HIST_BINS")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """No database, no operator pins; 64-bit mode off."""
    monkeypatch.setenv("F16_PERFDB", "0")
    for name in SHARED:
        monkeypatch.delenv(name, raising=False)
    with jax.enable_x64(False):
        yield


@pytest.fixture
def jax_shared(monkeypatch):
    """The JAX registry cut to the knobs both packages read, over the
    values the port can run (its card width stops at K1's window)."""
    domains = {k.name: k.domain for k in tuner.KNOBSPACE}
    monkeypatch.setattr(jtuner, "KNOBSPACE", tuple(
        k._replace(domain=tuple(v for v in k.domain if v in domains[k.name]))
        for k in jtuner.KNOBSPACE if k.name in SHARED))


def _parity_knob(mod, backend_ok):
    return mod.Knob("F16_TEST_PARITY", ("a", "b"), "a", True, "fit",
                    lambda shape, backend, model: backend_ok(backend)
                    and model in mod.ENSEMBLES, "test-only parity knob")


def table_measure(table, default):
    """Deterministic oracle: env (sorted items) -> wall seconds."""
    calls = []

    def measure(env, reps):
        calls.append((tuple(sorted(env.items())), reps))
        return table.get(tuple(sorted(env.items())), default)

    return measure, calls


def key(**env):
    return tuple(sorted({k: str(v) for k, v in env.items()}.items()))


def seed_rows(mod):
    return [
        mod.make_row("cpu", "probe.n400.t25", "config.A", {"fit_s": 3.0},
                     src="BENCH_r09", ts=1.0),
        mod.make_row("cpu", "probe.n400.t25", "config.B", {"fit_s": 2.0},
                     src="BENCH_r09", ts=1.0),
        mod.make_row("cpu", "probe.n400.t25", "config.A", {"fit_s": 9.0},
                     src="BENCH_r08", ts=1.0),
        mod.make_row("cpu", "audit", "audit.plan_peak",
                     {"peak_mb": 900.0}, src="audit", ts=1.0),
    ]


def test_knobspace_registers_what_the_port_reads():
    names = [k.name for k in tuner.KNOBSPACE]
    assert names == list(SHARED)
    assert tuner.registered_env_names() == frozenset(SHARED)
    jknobs = {k.name: k for k in jtuner.KNOBSPACE}
    for k in tuner.KNOBSPACE:
        assert k.name in rules_grid.KNOBS
        j = jknobs[k.name]
        # the port's domain is the JAX one cut to what K1 can run
        assert set(k.domain) <= set(j.domain)
        assert (k.default, k.parity_affecting, k.target) == (
            j.default, j.parity_affecting, j.target)
    assert not set(jknobs) - set(SHARED) & tuner.registered_env_names()


@pytest.mark.parametrize("model", [RF, ET, DT])
@pytest.mark.parametrize("env", [{}, {"F16_HIST_NODE_BATCH_CPU": "8"},
                                 {"F16_HIST_NODE_BATCH": "64"}])
def test_field_and_pins_equal_jax(jax_shared, model, env):
    shape = planner.plan_shape(FS, model, n=400, n_folds=10)
    for backend, jbackend in (("cpu", "cpu"), ("cuda", "tpu")):
        got = tuner.applicable_knobs(shape, backend, model, env=env)
        want = jtuner.applicable_knobs(shape, jbackend, model, env=env)
        assert [k.name for k in got] == [k.name for k in want]
        assert tuner.candidates(got) == jtuner.candidates(want)


def test_seeding_equal_jax():
    rows, jrows = seed_rows(perfdb), seed_rows(jperfdb)
    for members in ({"A", "B"}, {"A"}, {"C"}):
        assert tuner.family_history_wall(rows, "cpu", 400, 25, members) \
            == jtuner.family_history_wall(jrows, "cpu", 400, 25, members)
    assert tuner.family_history_wall(rows, "cpu", 400, 25, {"A", "B"}) \
        == 5.0
    peak = tuner.audit_peak_mb(rows)
    assert peak == jtuner.audit_peak_mb(jrows) == 900.0
    for env in ({"F16_HIST_NODE_BATCH_CPU": "16"},
                {"F16_HIST_NODE_BATCH_CPU": "8"},
                {"F16_HIST_NODE_BATCH": "256"}, {"OTHER": "512"}):
        for p, cap in ((peak, 1536.0), (None, 1536.0), (peak, 0.0)):
            assert tuner.mem_vetoed(env, p, cap) == \
                jtuner.mem_vetoed(env, p, cap)


def test_mem_veto_scales_from_the_audited_width():
    """A port audit's envelope carries the width it ran at (128 on the
    card): it is scaled from there, not from the JAX package's 8, and
    the anchor is the row with the largest peak per unit of width."""
    rows = [perfdb.make_row("cuda", "audit", "audit.scores.plan_batch[F/M]",
                            {"peak_mb": 40.0, "width": 128}, src="audit",
                            ts=1.0),
            perfdb.make_row("abstract", "audit", "audit.plan_peak",
                            {"peak_mb": 1.0}, src="audit", ts=1.0)]
    assert tuner.audit_envelope(rows) == (40.0, 128)
    assert tuner.audit_envelope(rows[1:]) == (1.0, None)
    peak, width = tuner.audit_envelope(rows)
    for w, cap, want in ((128, 39.0, True), (128, 40.0, False),
                         (64, 25.0, False), (64, 19.0, True),
                         (128, 3072.0, False)):
        env = {"F16_HIST_NODE_BATCH": str(w)}
        assert tuner.mem_vetoed(env, peak, cap, width) is want, (w, cap)
    # read from 8, as before, the same row would veto 64 at any cap
    # under 320 MB
    assert tuner.mem_vetoed({"F16_HIST_NODE_BATCH": "64"}, peak, 300.0)
    knobs = tuner.applicable_knobs(
        planner.plan_shape(FS, RF, n=400, n_folds=10), "cuda", RF, env={})
    verdicts = tuner.width_verdicts(knobs, peak, 30.0, width)
    assert verdicts == {"64": {"scaled_mb": 20.0, "vetoed": False},
                        "128": {"scaled_mb": 40.0, "vetoed": True}}
    assert tuner.width_verdicts(knobs, None, 30.0) == {}


def test_successive_halving_and_compose_equal_jax():
    seq = {"a": [5.0, 4.0, 6.0], "b": [5.0, 5.0, 5.0], "c": [7.0] * 3,
           "d": [6.0, 3.0, 9.0], "e": [5.0, 5.0, 4.0]}

    def oracle():
        hits = {n: 0 for n in seq}

        def measure(env, reps):
            name = env["NAME"]
            hits[name] += 1
            return seq[name][min(hits[name] - 1, 2)]
        return measure

    cands = [(n, {"NAME": n}) for n in sorted(seq)]
    for survivors in (2, 3):
        walls = tuner.successive_halving(cands, oracle(),
                                         min_survivors=survivors)
        assert walls == jtuner.successive_halving(
            cands, oracle(), min_survivors=survivors)
    knobs = tuner.applicable_knobs(planner.plan_shape(FS, RF, n=400,
                                                      n_folds=10),
                                   "cpu", RF, env={})
    walls = {"F16_HIST_NODE_BATCH_CPU=12": 8.0,
             "F16_HIST_NODE_BATCH_CPU=4": 9.5}
    jknobs = [k for k in jtuner.KNOBSPACE if k.name in SHARED]
    for base in (10.0, 9.0, 7.0):
        assert tuner.compose_best(knobs, walls, base) == \
            jtuner.compose_best(jknobs, walls, base)


def _both_tune(tmp_path, table, default, monkeypatch, *, model=RF,
               parity_check=None, jparity_check=None):
    """tune_family in each package on one oracle table at backend cpu,
    ``time.time`` pinned; returns [(result, oracle calls, recorded
    rows)] for the port, then the JAX package."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    out = []
    for mod, db_mod, check, name in (
            (tuner, perfdb, parity_check, "port"),
            (jtuner, jperfdb, jparity_check or parity_check, "jax")):
        measure, calls = table_measure(table, default)
        db = str(tmp_path / f"{name}.jsonl")
        res = mod.tune_family(FS, model, backend="cpu", n=400, n_trees=25,
                              n_folds=10, measure=measure,
                              parity_check=check, db=db)
        rows = db_mod.load(db) if os.path.exists(db) else []
        out.append((res, calls, rows))
    return out


@pytest.mark.parametrize("case", ["winner", "floor", "tie"])
def test_tune_family_equal_jax(tmp_path, monkeypatch, jax_shared, case):
    table, default = {
        "winner": ({key(): 10.0, key(F16_HIST_NODE_BATCH_CPU=16): 8.0,
                    key(F16_HIST_NODE_BATCH_CPU=12): 8.5}, 9.9),
        "floor": ({key(): 10.0, key(F16_HIST_NODE_BATCH_CPU=6): 9.9},
                  10.5),
        "tie": ({key(): 10.0, key(F16_HIST_NODE_BATCH_CPU=4): 7.0,
                 key(F16_HIST_NODE_BATCH_CPU=6): 7.0}, 11.0),
    }[case]
    (res, calls, rows), (jres, jcalls, jrows) = _both_tune(
        tmp_path, table, default, monkeypatch)
    assert calls == jcalls
    for field in ("family", "shape", "winner", "winner_env", "wall_s",
                  "base_wall_s", "gain_pct", "walls", "rejected"):
        assert getattr(res, field) == getattr(jres, field), field
    assert rows == jrows          # every field, ts pinned: the CRC too
    if case == "floor":
        assert res.winner == "base" and rows == []
    else:
        assert len(rows) == 1 and rows[0]["tuned"]
        assert perfdb.tuned_fit_overrides(
            "cpu", res.shape, model=RF, path=str(tmp_path / "port.jsonl"),
            env={}) == {"node_batch": int(
                res.winner_env["F16_HIST_NODE_BATCH_CPU"])}


def test_recorded_row_equal_jax_but_ts_and_crc(tmp_path, jax_shared):
    table = {key(): 10.0, key(F16_HIST_NODE_BATCH_CPU=8): 7.0}
    got = []
    for mod, db_mod, name in ((tuner, perfdb, "port"),
                              (jtuner, jperfdb, "jax")):
        measure, _ = table_measure(table, 9.0)
        db = str(tmp_path / f"{name}.jsonl")
        mod.tune_family(FS, ET, backend="cpu", n=400, n_trees=25,
                        n_folds=10, measure=measure, db=db)
        got.append(db_mod.load(db))
    bare = [[{k: v for k, v in r.items() if k not in ("ts", "crc")}
             for r in rows] for rows in got]
    assert len(bare[0]) == 1 and bare[0] == bare[1]
    # each package loads the other's row (CRC verified)
    assert perfdb.load(str(tmp_path / "jax.jsonl")) == got[1]
    assert jperfdb.load(str(tmp_path / "port.jsonl")) == got[0]


def test_parity_loop_equal_jax(tmp_path, monkeypatch, jax_shared):
    # the real parity-affecting knob, F16_HIST_BINS, in both registries
    table = {key(): 10.0, key(F16_HIST_BINS=32): 6.0,
             key(F16_HIST_NODE_BATCH_CPU=16): 8.0,
             key(F16_HIST_NODE_BATCH_CPU=16, F16_HIST_BINS=32): 5.5}

    def red_then_green():
        seen = []

        def check(env):
            seen.append(dict(env))
            return len(seen) > 1
        return check, seen

    check, seen = red_then_green()
    jcheck, jseen = red_then_green()
    (res, calls, rows), (jres, jcalls, jrows) = _both_tune(
        tmp_path, table, 10.5, monkeypatch, parity_check=check,
        jparity_check=jcheck)
    assert calls == jcalls and seen == jseen
    assert [r["reason"] for r in res.rejected] == ["parity"]
    assert res.winner_env == {"F16_HIST_BINS": "32"}
    assert seen == [{"F16_HIST_BINS": "32", "F16_HIST_NODE_BATCH_CPU": "16"},
                    {"F16_HIST_BINS": "32"}]
    for field in ("winner", "winner_env", "wall_s", "gain_pct", "walls",
                  "rejected"):
        assert getattr(res, field) == getattr(jres, field), field
    assert rows == jrows
    # no checker: the parity knob is never measured
    measure, calls = table_measure(table, 10.5)
    tuner.tune_family(FS, RF, backend="cpu", n=400, n_trees=25,
                      n_folds=10, measure=measure, record=False)
    assert "F16_HIST_BINS" not in {k for env, _ in calls for k, _ in env}
    # a test-only parity knob on the CPU alone: skipped on the card
    monkeypatch.setattr(tuner, "KNOBSPACE", tuner.KNOBSPACE + (
        _parity_knob(tuner, lambda b: b == "cpu"),))
    shape = planner.plan_shape(FS, RF, n=400, n_folds=10)
    assert "F16_TEST_PARITY" not in {
        k.name for k in tuner.applicable_knobs(shape, "cuda", RF, env={})}


def test_k1_width_veto(tmp_path):
    """No registered card width exceeds the widest window K1 holds in
    shared memory at any registered bin count, so the field on ``cuda`` is
    the default, 64 (the JAX package's 256 is not registered) and, with
    a parity oracle, the two other bin counts."""
    from flake16_framework_tpu_torch.constants import HIST_BINS
    from flake16_framework_tpu_torch.kernels.hist import max_window

    assert max_window(HIST_BINS) == 226
    (knob,) = [k for k in tuner.KNOBSPACE if k.name == "F16_HIST_NODE_BATCH"]
    (bins,) = [k for k in tuner.KNOBSPACE if k.name == "F16_HIST_BINS"]
    for b in bins.domain:
        assert max(int(v) for v in knob.domain) <= max_window(int(b))
    shape = planner.plan_shape(FS, RF, n=4000, n_folds=10)
    knobs = tuner.applicable_knobs(shape, "cuda", RF, env={})
    assert [n for n, _ in tuner.candidates(knobs)] == [
        "base", "F16_HIST_NODE_BATCH=64", "F16_HIST_BINS=32",
        "F16_HIST_BINS=48"]
    logs = []
    measure, calls = table_measure({key(): 10.0}, 9.0)
    res = tuner.tune_family(FS, RF, backend="cuda", n=4000, n_trees=100,
                            n_folds=10, measure=measure,
                            db=str(tmp_path / "db.jsonl"), log=logs.append)
    assert [env for env, _ in calls] == [key(), key(F16_HIST_NODE_BATCH=64)]
    assert "vetoed" not in logs[0]
    assert res.winner_env == {"F16_HIST_NODE_BATCH": "64"}
    assert perfdb.load(str(tmp_path / "db.jsonl"))[0]["backend"] == "cuda"


def test_tune_without_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--dry-run"], ["--n", "60", "--trees", "4"],
                 ["--backend", "cuda", "--dry-run"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tuner.tune_main(argv, out=io.StringIO())
    # the explicit request for the CPU is served
    buf = io.StringIO()
    assert tuner.tune_main(["--dry-run", "--backend", "cpu", "--n", "400",
                            "--trees", "25"], out=buf) == 0
    rec = json.loads(buf.getvalue())
    assert rec["backend"] == "cpu" and sorted(rec["families"]) == [
        "Flake16/Extra Trees", "Flake16/Random Forest",
        "FlakeFlagger/Random Forest"]


def test_dry_run_field_equal_jax(jax_shared, flags=()):
    buf, jbuf = io.StringIO(), io.StringIO()
    argv = ["--dry-run", "--backend", "cpu", "--n", "400", "--trees",
            "25", *flags]
    assert tuner.tune_main(argv, out=buf) == 0
    assert jtuner.tune_main(argv, out=jbuf) == 0
    rec, jrec = json.loads(buf.getvalue()), json.loads(jbuf.getvalue())
    assert set(rec["families"]) == set(jrec["families"])
    for fam, got in rec["families"].items():
        want = jrec["families"][fam]
        assert got == want


def test_dry_run_without_parity_knobs_equal_jax(jax_shared):
    test_dry_run_field_equal_jax(jax_shared, flags=["--no-parity-knobs"])
    buf = io.StringIO()
    tuner.tune_main(["--dry-run", "--backend", "cpu", "--no-parity-knobs"],
                    out=buf)
    for fam in json.loads(buf.getvalue())["families"].values():
        assert not any("F16_HIST_BINS" in c for c in fam["candidates"])


def test_failed_probe_fails_tune(monkeypatch):
    def fake(fs_name, model_name, **kw):
        def measure(env, reps):
            ok = not env
            measure.probes.append({"candidate": env, "reps": reps,
                                   "rc": 0 if ok else 1,
                                   "wall_s": 10.0 if ok else None})
            return 10.0 if ok else float("inf")
        measure.probes = []
        return measure

    monkeypatch.setattr(tuner, "subprocess_measure", fake)
    buf = io.StringIO()
    code = tuner.tune_main(["--backend", "cpu", "--family",
                            "Flake16/Random Forest", "--n", "60",
                            "--trees", "4"], out=buf)
    rec = json.loads(buf.getvalue())["families"]["Flake16/Random Forest"]
    assert code == 1 and rec["winner"] == "base"
    # base, five CPU widths and two bin counts: 8 + 4 + 3 probes, all
    # failed but the base's three
    assert rec["failed_probes"] == 12 and len(rec["probes"]) == 15


def test_tuner_and_analysis_import_no_torch():
    code = ("import sys; import flake16_framework_tpu_torch.perf.tuner; "
            "import flake16_framework_tpu_torch.perf.probe; "
            "import flake16_framework_tpu_torch.analysis.cli; "
            "bad = {'torch', 'jax', 'flake16_framework_tpu'} & "
            "{m.split('.')[0] for m in sys.modules}; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_probe_child_on_the_cpu():
    measure = tuner.subprocess_measure(FS, RF, backend="cpu", n=60,
                                       n_trees=4, timeout_s=240)
    wall = measure({"F16_HIST_NODE_BATCH_CPU": "4"}, 1)
    (probe,) = measure.probes
    assert 0.0 < wall < float("inf") and probe["rc"] == 0
    assert not tuner.probe_failed(probe)
    assert probe["launches"] == {"hist_cumsum": 0, "treeshap_unit": 0}
    assert probe["knobs"]["F16_HIST_NODE_BATCH_CPU"] == "4"
    assert probe["knobs"]["F16_PERFDB"] == "0"
