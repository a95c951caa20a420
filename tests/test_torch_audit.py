"""The port's audit (``analysis/ir.py``'s recorder, ``analysis/rules_ir.py``,
the ``audit`` verb and ``lint --ir``) against the JAX package's
``analysis/rules_ir.py`` on the same inputs, on the CPU.

Held: the I catalog (the JAX one minus I501); the static census of both
arms and the census, SHAP census and budget findings, message for
message; each I rule on a seeded fixture and quiet on its clean twin;
the memory envelope on a hand-checked sequence of allocations; every
listed host-read name reaching the function mode and the recorder; the
audit itself on a sub-grid (two configs a family, six plans) with no
finding; the document under both packages' validators and perf
databases; the verbs' exit codes; the import contract."""

import io
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from flake16_framework_tpu import config as jcfg
from flake16_framework_tpu.analysis import cli as jcli
from flake16_framework_tpu.analysis import rules_ir as jrules_ir
from flake16_framework_tpu.obs import perfdb as jperfdb
from flake16_framework_tpu.obs import schema as jschema
from flake16_framework_tpu.parallel import planner as jplanner
from flake16_framework_tpu_torch import __main__ as tmain
from flake16_framework_tpu_torch import config as cfg, rng
from flake16_framework_tpu_torch.analysis import cli, ir, rules_ir
from flake16_framework_tpu_torch.obs import perfdb, schema
from flake16_framework_tpu_torch.ops import trees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREES = {"Random Forest": 2, "Extra Trees": 2}
MIB = 2 ** 20


def _subgrid():
    """Two configs of each of the six families."""
    fams = {}
    for keys in cfg.iter_config_keys():
        fams.setdefault((keys[1], keys[4]), []).append(tuple(keys))
    return [k for v in fams.values() for k in v[:2]]


@pytest.fixture(scope="module")
def audit():
    """One audit on the CPU over the sub-grid, with no database."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("F16_PERFDB", "0")
        mp.delenv("F16_DEVICE_BUDGET_MB", raising=False)
        mp.delenv("F16_HIST_NODE_BATCH_CPU", raising=False)
        return rules_ir.run_audit(backend="cpu", configs=_subgrid())


def _bare(f):
    return f.rule, f.severity, f.message, f.snippet


def test_catalog_is_jax_minus_i501():
    want = {rid: r.severity for rid, r in jrules_ir.RULES.items()
            if rid != "I501"}
    assert {rid: r.severity for rid, r in rules_ir.RULES.items()} == want
    assert rules_ir.PACK_NAME == jrules_ir.PACK_NAME == "ir"
    assert "I501" in rules_ir.__doc__


@pytest.mark.parametrize("n,n_folds,overrides", [
    (120, 10, TREES), (64, 10, None), (400, 26, {"Random Forest": 5})])
def test_static_census_equals_jax(n, n_folds, overrides):
    plans = rules_ir.static_plans(n=n, n_folds=n_folds,
                                  tree_overrides=overrides)
    jplans = jrules_ir.static_plans(n=n, n_folds=n_folds,
                                    tree_overrides=overrides)
    assert [(p.family, p.configs, p.shape, p.batch) for p in plans] == \
        [(p.family, p.configs, p.shape, p.batch) for p in jplans]
    shap = rules_ir.static_shap_plans(n=n, n_folds=n_folds, n_explain=16,
                                      tree_overrides=overrides)
    jshap = jplanner.plan_explain_grid(
        list(jcfg.iter_config_keys()), devices=1, n=n, n_folds=n_folds,
        n_explain=16, tree_overrides=overrides)
    assert [(p.family, p.configs, p.shape) for p in shap] == \
        [(p.family, p.configs, p.shape) for p in jshap]
    assert len(plans) == len(shap) == 6


@pytest.mark.parametrize("runtime", [None, 6, 7, 5])
def test_census_and_budget_findings_equal_jax(runtime):
    plans = rules_ir.static_plans()
    jplans = jrules_ir.static_plans()
    for port, jax_ in ((rules_ir.census_findings,
                        jrules_ir.census_findings),
                       (rules_ir.shap_census_findings,
                        jrules_ir.shap_census_findings)):
        got, info = port(plans, runtime_count=runtime)
        if runtime is None:
            # the JAX side reads the committed BENCH files; the port has
            # none to read and leaves the census unreconciled
            assert got == [] and info["match"] is None
            continue
        want, jinfo = jax_(jplans, runtime_count=runtime)
        assert [_bare(f) for f in got] == [_bare(f) for f in want]
        assert [f.path.replace("_torch", "") for f in got] == \
            [f.path for f in want]
        assert info == jinfo
    env = {"arg_bytes": 0, "out_bytes": 0, "peak_bytes": 64 * MIB}
    for budget in (1.0, 63.9, 64.0, 100.0, None, 0):
        got = rules_ir.budget_findings("fix.plan", env, budget_mb=budget)
        want = jrules_ir.budget_findings("fix.plan", env, budget_mb=budget)
        assert [_bare(f) for f in got] == [_bare(f) for f in want]
        assert bool(got) == (budget in (1.0, 63.9))


def test_function_mode_sees_every_host_read():
    seen = []

    class Seen(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            seen.append(getattr(func, "__name__", None))
            return func(*args, **(kwargs or {}))

    t = torch.arange(4.0)
    s = t.sum()
    with Seen():
        s.item()
        bool(s)
        int(s)
        float(s)
        range(10)[s.long()]
        t.tolist()
        t.numpy()
        np.asarray(t)
        t.cpu()
        t.to("cpu")
    assert set(ir.HOST_READS) | set(ir.HOST_MOVES) <= set(seen)


def _reads(t):
    s = t.sum()
    s.item()
    bool(s > 0)
    int(s)
    float(s)
    range(10)[s.long() % 10]
    t.tolist()
    t.numpy()
    np.asarray(t)
    t.cpu()
    return s


def test_recorder_counts_each_read_at_its_site():
    rec, _ = ir.trace_entry(_reads, (torch.arange(4.0),), device="cpu")
    line = _reads.__code__.co_firstlineno
    where = "tests/test_torch_audit.py"
    # cpu() of a CPU tensor moves nothing, so it is no read on the CPU
    assert rec["host_reads"] == {
        f"{where}:{line + k} (_reads)": 1 for k in range(2, 10)}


def test_envelope_hand_checked():
    def steps(arg, arg_view):
        a = torch.empty(MIB // 4)           # 1 MiB
        b = torch.empty(MIB // 2)           # 2 MiB
        view = b[10:]                       # no new storage
        view.zero_()
        del a                               # frees 1 MiB
        c = torch.empty(MIB // 4)           # 1 MiB
        return c

    arg = torch.zeros(1024)
    rec, out = ir.trace_entry(steps, (arg, arg[1:]), device="cpu")
    assert rec["arg_bytes"] == 4096                 # the view counts once
    assert rec["peak_bytes"] == 3 * MIB + 4096
    assert rec["out_bytes"] == MIB
    assert out.numel() == MIB // 4


def _serve_like(x):
    return x * 2.0


def _serve_like_read(x):
    y = x * 2.0
    y[0].item()
    return y


def _with_rand(x):
    return x + torch.rand(x.shape)


def _with_threefry(x):
    return x + rng.uniform(rng.prng_key(0, x.device), x.shape)


def _with_double(x):
    return x.double().sum().float()


def _with_fma(x):
    return trees._fma(x, x, x)


def _put(x):
    return x.put_(torch.tensor([1, 1]), x[:2].clone(), accumulate=False)


def test_flagged_op_warning_becomes_an_i201_record():
    """On ``cuda`` the recorder turns deterministic mode's warnings into
    records; here, on the CPU, its handler takes ``put_``'s (flagged on
    every device) with the mode switched on by hand, once each call."""
    prev = torch.are_deterministic_algorithms_enabled()
    rec = ir.Recorder("cpu")
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with rec, rec.window("fix"), warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = rec._warning
            _put(torch.ones(4))
            _put(torch.ones(4))
    finally:
        torch.use_deterministic_algorithms(prev)
    line = _put.__code__.co_firstlineno + 1
    nondet = rec.records[0]["nondet"]
    assert nondet == {f"put_ @ tests/test_torch_audit.py:{line} (_put)": 2}
    assert [f.rule for f in rules_ir.program_findings(
        "fix", rec.records[0], path="fix.py")] == ["I201"]


def _findings(fn, declared=None):
    rec, _ = ir.trace_entry(fn, (torch.ones(8),), entry="fix",
                            device="cpu")
    return sorted({f.rule for f in rules_ir.program_findings(
        "fix", rec, path="fix.py", declared=declared)})


def test_rules_fire_on_seeded_fixtures():
    # I101: a serve-like entry declares no read
    assert _findings(_serve_like_read, declared={}) == ["I101"]
    assert _findings(_serve_like, declared={}) == []
    # I201: a random aten op; the port's own threefry is quiet
    assert _findings(_with_rand) == ["I201"]
    assert _findings(_with_threefry) == []
    # I202: float64 outside the declared sites; trees._fma is declared
    assert _findings(_with_double) == ["I202"]
    assert _findings(_with_fma) == []
    # I401: a budget under the measured peak
    rec, _ = ir.trace_entry(_serve_like, (torch.ones(MIB),), device="cpu")
    peak_mb = rec["peak_bytes"] / MIB
    assert [f.rule for f in rules_ir.budget_findings(
        "fix", rec, budget_mb=peak_mb * 0.9)] == ["I401"]
    assert rules_ir.budget_findings("fix", rec, budget_mb=peak_mb) == []


def test_i102_crosscheck_fires_on_ast_blind_spot(tmp_path, monkeypatch):
    """A read the recorder sees in a module where the J402/J601
    heuristics see nothing warns; a module the heuristics flag does not,
    and an entry with no undeclared read has nothing to cross-check."""
    (tmp_path / "audit_innocent.py").write_text(
        "def entry(x):\n    y = x.sum()\n    y.item()\n    return y\n")
    (tmp_path / "audit_flagged.py").write_text(
        "def entry(x):\n    for _ in range(2):\n        y = x.cpu()\n"
        "    return y.sum().item()\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    import audit_flagged
    import audit_innocent

    for mod, want in ((audit_innocent, ["I102"]), (audit_flagged, [])):
        rec, _ = ir.trace_entry(mod.entry, (torch.ones(4),), entry="fix",
                                device="cpu")
        assert rec["host_reads"]
        got = rules_ir.crosscheck_findings("fix", rec, declared={})
        assert [f.rule for f in got] == want
        assert all(f.severity == "warning" for f in got)
    rec, _ = ir.trace_entry(_serve_like, (torch.ones(4),), device="cpu")
    assert rules_ir.crosscheck_findings("fix", rec, declared={}) == []


def test_audit_subgrid_is_clean(audit):
    findings, info = audit
    assert findings == []
    for c in (info["census"], info["shap_census"]):
        assert c == {"static": 6, "runtime": 6, "source": "executor",
                     "match": True}
    assert info["backend"] == "cpu" and len(info["entries"]) == 19
    envs = {e["entry"]: e for e in info["envelopes"]}
    assert list(envs) == info["entries"]
    plans = [e for e in envs if e.startswith(("scores.plan_batch[",
                                              "shap.plan_batch"))]
    assert len(plans) == 14
    for name in plans:
        e = envs[name]
        assert e["width"] == 8 and e["batch"] == 2, e
        assert e["peak_bytes"] >= e["arg_bytes"] > 0
        assert e["host_reads"] and e["aten_ops"] > 0
        # the CPU runs the kernels' plain versions: nothing launches
        assert e["k1_launches"] == e["k2_launches"] == 0
    for name in ("serve.predict", "serve.shap"):
        assert envs[name]["host_reads"] == {}
    assert envs["shap.path"]["host_reads"] == {}
    for name in ("shap.interventional", "shap.interactions"):
        assert set(envs[name]["host_reads"]) == {
            f"flake16_framework_tpu_torch/ops/treeshap.py:{line} "
            "(bucket_inputs)" for line in (177, 183, 184)}


def test_documents_cross_validate_and_ingest(audit, tmp_path):
    doc = cli.audit_report(*audit)
    doc = json.loads(json.dumps(doc))
    assert schema.validate_audit_report(doc) == []
    assert jschema.validate_audit_report(doc) == []
    assert schema.validate_audit_report({"schema": "x"}) != []
    jdoc = jcli.audit_report([], {
        "census": {"static": 6, "runtime": 6, "source": "BENCH_r08.json",
                   "match": True},
        "shap_census": None, "entries": ["scores.plan_batch[F/M]"],
        "envelopes": [{"entry": "scores.plan_batch[F/M]", "batch": 36,
                       "arg_bytes": 1000, "out_bytes": 2000,
                       "peak_bytes": 3 * MIB, "peak_mb": 3.0}],
        "budget_mb": None})
    assert schema.validate_audit_report(jdoc) == []
    strip = ("ts", "crc", "src")

    def bare(rows):
        return [{k: v for k, v in r.items() if k not in strip}
                for r in rows]

    assert bare(perfdb.rows_from_audit(jdoc)) == \
        bare(jperfdb.rows_from_audit(jdoc))
    rows, jrows = perfdb.rows_from_audit(doc), jperfdb.rows_from_audit(doc)
    assert len(rows) == len(jrows) == 19
    assert {r["backend"] for r in rows} == {r["backend"] for r in jrows} \
        == {"cpu"}
    assert all(r["metrics"]["width"] == 8 for r in rows)
    assert all("width" not in r["metrics"] for r in jrows)
    for d in (doc, jdoc):
        path = tmp_path / "audit.json"
        path.write_text(json.dumps(d))
        assert bare(perfdb.rows_from_path(str(path))) == \
            bare(perfdb.rows_from_audit(d))


def _run(*argv):
    return subprocess.run(
        [sys.executable, "-m", "flake16_framework_tpu_torch", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=120)


def test_verbs_exit_codes(audit, monkeypatch):
    for argv, what in ((["audit", "--no-mesh"], "no mesh"),
                       (["lint", "--backend", "cpu"], "--ir")):
        proc = _run(*argv)
        assert proc.returncode == cli.USAGE_EXIT == 2, proc.stderr
        assert what in proc.stderr and "Traceback" not in proc.stderr
    with pytest.raises(ValueError, match="ROADMAP"):
        tmain.main(["bench", "--gate"])
    findings, info = audit
    over = [f for env in info["envelopes"] for f in rules_ir.budget_findings(
        env["entry"], env, budget_mb=1e-3)]
    monkeypatch.setattr(rules_ir, "run_audit",
                        lambda **kw: (over, dict(info, budget_mb=1e-3)))
    out = io.StringIO()
    assert cli.audit_main(["--backend", "cpu", "--json"], out=out) == 1
    rep = json.loads(out.getvalue())
    assert {f["rule"] for f in rep["findings"]} == {"I401"}
    assert rep["counts"]["errors"] == len(over) > 0
    out = io.StringIO()
    assert cli.lint_main(["--ir", "--backend", "cpu", "--json"],
                         out=out) == 1
    assert {f["rule"] for f in json.loads(out.getvalue())["findings"]} \
        == {"I401"}
    monkeypatch.setattr(rules_ir, "run_audit", lambda **kw: audit)
    out = io.StringIO()
    assert cli.audit_main(["--backend", "cpu"], out=out) == 0
    assert "census static=6 runtime=6 (executor)" in out.getvalue()


def test_audit_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rules_ir.run_audit()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.audit_main([])


def test_cli_and_rules_import_no_torch():
    code = ("import sys\n"
            "import flake16_framework_tpu_torch.analysis.cli\n"
            "import flake16_framework_tpu_torch.analysis.rules_ir\n"
            "print('torch' in sys.modules, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


def test_per_family_audits_a_sample_of_each_family(monkeypatch):
    sample = rules_ir.family_sample(2)
    # the audit fixture's sub-grid, in the canonical grid order
    assert len(sample) == 12 and set(sample) == set(_subgrid())
    fams = [(k[1], k[4]) for k in sample]
    assert all(fams.count(f) == 2 for f in fams)
    assert len(rules_ir.static_plans(configs=sample)) == len(
        rules_ir.static_plans()) == 6
    with pytest.raises(ValueError, match="at least 1"):
        rules_ir.family_sample(0)
    seen = []

    def fake(**kw):
        seen.append(kw.get("configs"))
        return [], {"census": {"static": 6, "runtime": 6,
                               "source": "executor", "match": True},
                    "shap_census": None, "entries": [], "envelopes": [],
                    "budget_mb": None, "backend": "cpu"}

    monkeypatch.setattr(rules_ir, "run_audit", fake)
    assert cli.audit_main(["--backend", "cpu", "--per-family", "2"],
                          out=io.StringIO()) == 0
    assert cli.lint_main(["--ir", "--backend", "cpu", "--per-family", "2",
                          "--json"], out=io.StringIO()) == 0
    assert cli.audit_main(["--backend", "cpu"], out=io.StringIO()) == 0
    assert seen == [sample, sample, None]
    with pytest.raises(cli.UsageError, match="--per-family"):
        cli.lint_main(["--per-family", "2"], out=io.StringIO())
