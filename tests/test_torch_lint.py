"""The port's lint (``analysis/``: the engine, the E/J/G/O/C packs, the
``lint`` verb and the baseline writer) against the JAX package's
``analysis/`` on the same sources, on the CPU.

Held: the E, C and O findings of both engines on the JAX package's
seeded fixture (``tests/lint_fixtures/fixture_violations.py``) and on
seeded files; the G findings of both pre-flights on seeded grids, knob
reads, span collisions and tunable constants; baselines written by
either engine loading in the other; the J pack firing on
``tests/torch_lint_cases.py`` and a seeded serve hot module at their
marked lines; suppressions and the baseline ratchet; the ``--json``
document under both packages' ``LINT_SCHEMA`` validators; ``--rules``;
refused options and verbs; the port linting clean with a reason on every
suppression; no ``analysis/`` module importing torch or jax."""

import ast
import io
import json
import os
import re
import tokenize

import jax
import pytest

from flake16_framework_tpu.analysis import Engine as JEngine
from flake16_framework_tpu.analysis import engine as jeng
from flake16_framework_tpu.analysis import rules_conc as jrules_conc
from flake16_framework_tpu.analysis import rules_grid as jrules_grid
from flake16_framework_tpu.analysis import rules_obs as jrules_obs
from flake16_framework_tpu.obs import schema as jschema
from flake16_framework_tpu_torch import __main__ as tmain
from flake16_framework_tpu_torch.analysis import Engine, Module
from flake16_framework_tpu_torch.analysis import baseline as tbaseline
from flake16_framework_tpu_torch.analysis import engine as eng
from flake16_framework_tpu_torch.analysis import (
    rules_conc, rules_grid, rules_ir, rules_obs, rules_torch,
)
from flake16_framework_tpu_torch.analysis.cli import PACKS, lint_main
from flake16_framework_tpu_torch.obs import schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "lint_fixtures",
                       "fixture_violations.py")
CASES = os.path.join(REPO, "tests", "torch_lint_cases.py")
PORT = os.path.join(REPO, "flake16_framework_tpu_torch")


@pytest.fixture(autouse=True)
def _in_repo(monkeypatch):
    """Paths relative to the repository, as the gate runs; 64-bit mode
    off."""
    monkeypatch.chdir(REPO)
    with jax.enable_x64(False):
        yield


def _keys(findings):
    return [(f.rule, f.path, f.line) for f in findings]


def _lint_both(packs, jpacks, paths):
    return (_keys(Engine(packs).lint(paths).findings),
            _keys(JEngine(jpacks).lint(paths).findings))


SYNTAX_ERROR = "def broken(:\n    pass\n"

OBS_SEEDS = '''\
from flake16_framework_tpu import obs


def emit():
    with obs.span("Bad Name"):
        obs.event("no_such_kind", x=1)
    obs.event("span", name="a.b", wall_s=0.0, cold=False)
    obs.gauge("not_a_metric", 1.0)
    obs.counter_add("not_a_counter", 1)
    return [{"kind": "made_up", "ts": 0.0},
            {"schema": "flake16-perfdb-v9"},
            {"id": 1, "op": "score", "bogus": 2},
            {"id": 1, "ok": True, "extra": 3}, {"hb": 1}]
'''


@pytest.mark.parametrize("case", ["fixture", "syntax", "obs_seeds"])
def test_e_c_o_findings_equal_jax(tmp_path, case):
    if case == "fixture":
        paths = [FIXTURE]
    else:
        path = tmp_path / f"{case}.py"
        path.write_text(SYNTAX_ERROR if case == "syntax" else OBS_SEEDS)
        paths = [str(path)]
    got, want = _lint_both((rules_conc, rules_obs),
                           (jrules_conc, jrules_obs), paths)
    assert got == want
    rules = {r for r, _, _ in got}
    if case == "fixture":
        assert {r for r in rules if r[0] == "C"} == set(rules_conc.RULES)
        assert {"O102", "O103", "O104", "O105", "O106", "O107"} <= rules
    elif case == "syntax":
        assert rules == {"E001"}
    else:
        assert {"O102", "O103", "O104", "O105", "O106", "O107"} <= rules


def _g_keys(findings, pkg):
    """(rule, path with the package name cut, line) for G findings; the
    pre-flight's findings name each package's own files."""
    return [(f.rule, f.path.replace(pkg + "/", "PKG/"), f.line)
            for f in findings]


GRIDS = {
    "axes": lambda a: a[:4],
    "empty_axis": lambda a: (a[0], {}, *a[2:]),
    "codes": lambda a: (a[0], a[1], {**a[2], "Extra": 7}, *a[3:]),
    "columns": lambda a: (a[0], {**a[1], "Bad": (0, 0, 99)}, *a[2:]),
    "unhashable": lambda a: (a[0], {**a[1], "L": [1, 2]}, *a[2:]),
    "labels": lambda a: ({**a[0], "X": "y"}, *a[1:]),
    "size": lambda a: a,
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_grid_preflight_equal_jax(grid):
    from flake16_framework_tpu import config as jcfg
    from flake16_framework_tpu_torch import config as cfg

    kw = {"n_features": 16, "switch_arities": {"preprocessing": 3,
                                               "balancing": 6},
          "expected_size": 100 if grid == "size" else None}
    got = rules_grid.preflight_grid(GRIDS[grid](cfg.GRID_AXES), **kw)
    want = jrules_grid.preflight_grid(GRIDS[grid](jcfg.GRID_AXES), **kw)
    assert _g_keys(got, "flake16_framework_tpu_torch") == \
        _g_keys(want, "flake16_framework_tpu")
    assert [_head(f) for f in got] == [_head(f) for f in want]
    assert got, grid


def _head(finding):
    """A finding's message up to its advice (the part that names what is
    wrong, worded alike in both packages)."""
    return finding.message.split(" — ")[0].split(" but the implemented")[0]


def test_grid_preflight_reads_the_port():
    assert rules_grid.preflight_grid() == []
    assert rules_grid.default_switch_arities() == {"preprocessing": 3,
                                                   "balancing": 6}
    bad = rules_grid.preflight_grid(switch_arities={"preprocessing": 2,
                                                    "balancing": 6})
    assert [f.rule for f in bad] == ["G102"]


G_SEEDS = {
    "knob_read": ('import os\n\nX = os.environ.get("F16_NOT_A_KNOB", "")\n'
                  'Y = os.environ["F16_TELEMETRY"]\n'),
    "span_a": 'from p import obs\n\nobs.span("dup.name")\n',
    "span_b": 'from p import obs\n\nobs.span("dup.name")\n',
    "executor": ('from p.sweep import executor_scope\n\n\n@executor_scope\n'
                 'def loop(engine, plan):\n    for k in plan.configs:\n'
                 '        engine.run_config(k)\n'),
    "tunable": ('import {lib}\n\nNODE_BATCH = 64\nSHAP_CHUNK = 25\n'
                'F16_X_TILE = 3\nNOTATUNABLE = 9\nHIST_NODE_BATCH = 128\n'),
}


def test_grid_module_and_project_rules_equal_jax(tmp_path):
    paths = []
    for name, src in sorted(G_SEEDS.items()):
        path = tmp_path / f"{name}.py"
        path.write_text(src.replace("{lib}", "torch"))
        paths.append(str(path))
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jpaths = []
    for path in paths:
        jpath = jdir / os.path.basename(path)
        jpath.write_text(open(path).read().replace("import torch",
                                                   "import jax"))
        jpaths.append(str(jpath))

    def own(findings, where):
        return [(f.rule, os.path.basename(f.path), f.line, f.message)
                for f in findings if os.path.dirname(
                    os.path.join(REPO, f.path)) == where]

    got = own(Engine((rules_grid,)).lint(paths).findings, str(tmp_path))
    want = own(JEngine((jrules_grid,)).lint(jpaths).findings, str(jdir))
    strip = [(r, p, n) for r, p, n, _ in got]
    assert strip == [(r, p, n) for r, p, n, _ in want]
    assert [r for r, _, _ in strip] == [
        "G107", "G106", "G105", "G108", "G108", "G108"]
    # G108 fires only in a torch-importing module
    plain = tmp_path / "plain.py"
    plain.write_text(G_SEEDS["tunable"].replace("import {lib}", ""))
    assert rules_grid.check_tunable_constants(Module(str(plain))) == []


def test_knob_census_covers_the_port():
    reads = {}
    for mod in Engine(PACKS).parse([PORT]):
        for name, _ in rules_grid._knob_reads(mod):
            reads.setdefault(name, []).append(mod.path)
    assert set(reads) == set(rules_grid.KNOBS)
    assert rules_grid.preflight_knob_values({}) == []
    bad = rules_grid.preflight_knob_values(
        {"F16_ENSEMBLE_GROWER": "hsit", "F16_HIST_NODE_BATCH": "0"})
    jbad = jrules_grid.preflight_knob_values(
        {"F16_ENSEMBLE_GROWER": "hsit", "F16_HIST_NODE_BATCH": "0"})
    assert [_head(f) for f in bad] == [_head(f) for f in jbad]
    assert len(bad) == 2


# J601 scopes by location: a serve hot module, seeded under serve/.
HOT_SEED = (
    "import torch\n\n\n"
    "def hot_reads(y, z):\n"
    "    a = y.item()  # expect J601\n"
    "    b = z.tolist()  # expect J601\n"
    "    torch.cuda.synchronize()  # expect J601\n"
    "    return a, b\n")


def _hot_seed(tmp_path):
    hot = tmp_path / "serve" / "batcher.py"
    hot.parent.mkdir()
    hot.write_text(HOT_SEED)
    return hot


def test_j_pack_fires_on_the_torch_cases(tmp_path):
    hot = _hot_seed(tmp_path)
    result = Engine((rules_torch,)).lint([CASES, str(hot)])
    expected = []
    for path in (CASES, str(hot)):
        with open(path) as fd:
            lines = fd.read().splitlines()
        expected += [(os.path.basename(path), m.group(1), i)
                     for i, line in enumerate(lines, 1)
                     for m in re.finditer(r"expect (J\d+)", line)]
    expected.sort()
    assert sorted((os.path.basename(f.path), f.rule, f.line)
                  for f in result.findings) == expected
    expected = [(r, n) for _, r, n in expected]
    assert {r for r, _ in expected} == set(rules_torch.RULES)
    assert result.suppressed_inline == 2


def test_j601_by_location(tmp_path):
    src = "def f(y):\n    return y.cpu()\n"
    for name, fires in (("batcher.py", True), ("service.py", False)):
        path = tmp_path / "serve" / name
        path.parent.mkdir(exist_ok=True)
        path.write_text(src)
        got = [f.rule for f in Engine((rules_torch,)).lint(
            [str(path)]).findings]
        assert got == (["J601"] if fires else [])


def test_suppressions_and_baseline_equal_jax(tmp_path):
    src = ("import threading\n_a = threading.Lock()\n_b = threading.Lock()"
           "\n\n\ndef f():\n    with _a:\n        with _b:\n"
           "            pass\n\n\ndef g():\n    with _b:\n        with _a:"
           "\n            pass\n\n\ndef start():\n"
           "    threading.Thread(target=f).start()\n"
           "    threading.Thread(target=g).start()\n")
    path = tmp_path / "inv.py"
    path.write_text(src)
    res = Engine((rules_conc,)).lint([str(path)])
    jres = JEngine((jrules_conc,)).lint([str(path)])
    assert [f.fingerprint for f in res.findings] == \
        [f.fingerprint for f in jres.findings] != []
    base, jbase = tmp_path / "b.json", tmp_path / "jb.json"
    eng.save_baseline(str(base), res.findings)
    jeng.save_baseline(str(jbase), jres.findings)
    # each baseline loads in the other package's engine and absorbs alike
    for doc in (base, jbase):
        fps = eng.load_baseline(str(doc), rules=Engine(PACKS).rules)
        jfps = jeng.load_baseline(str(doc), rules=JEngine(
            (jrules_conc,)).rules)
        assert sorted(fps) == sorted(jfps)
        again = Engine((rules_conc,)).lint([str(path)], baseline=fps)
        assert again.findings == [] and again.suppressed_baseline == 1
    # a JAX-only rule id in a baseline is refused by the port's catalog
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": eng.BASELINE_SCHEMA,
                               "packs": {"jax": ["J101:0123456789abcdef"]}}))
    with pytest.raises(ValueError, match="unknown to the catalog"):
        eng.load_baseline(str(bad), rules=Engine(PACKS).rules)
    # inline suppression (line and file) counts and hides
    path.write_text(src.replace("with _b:\n            pass",
                                "with _b:  # f16lint: disable=C201\n"
                                "            pass"))
    res = Engine((rules_conc,)).lint([str(path)])
    assert res.findings == [] and res.suppressed_inline == 1
    path.write_text("# f16lint: disable-file=C201\n" + src)
    assert Engine((rules_conc,)).lint([str(path)]).findings == []


def test_baseline_writer_ratchet(tmp_path):
    out = str(tmp_path / "lint_baseline.json")
    buf = io.StringIO()
    assert tbaseline.main([CASES, "--out", out], out=buf) == 0
    assert "fingerprint(s) (all packs)" in buf.getvalue()
    with open(out) as fd:
        doc = json.load(fd)
    assert doc["schema"] == eng.BASELINE_SCHEMA
    assert sorted(doc["packs"]) == ["torch"]
    assert lint_main([CASES, "--baseline", out], out=io.StringIO()) == 0
    # per-pack regeneration keeps the other sections verbatim
    doc["packs"]["concurrency"] = ["C201:0000000000000000"]
    with open(out, "w") as fd:
        json.dump(doc, fd)
    assert tbaseline.main([CASES, "--out", out, "--pack", "grid"],
                          out=io.StringIO()) == 0
    with open(out) as fd:
        regen = json.load(fd)
    assert regen["packs"]["torch"] == doc["packs"]["torch"]
    assert regen["packs"]["concurrency"] == ["C201:0000000000000000"]
    with pytest.raises(ValueError, match="unknown pack"):
        tbaseline.main(["--pack", "jax", "--out", out])


def test_cli_json_rules_and_refusals(tmp_path):
    out = io.StringIO()
    assert lint_main([CASES, str(_hot_seed(tmp_path)), "--json"],
                     out=out) == 1
    report = json.loads(out.getvalue())
    assert schema.validate_lint_report(report) == []
    assert jschema.validate_lint_report(report) == []
    assert report["packs"] == ["concurrency", "engine", "grid", "ir",
                               "obs", "torch"]
    assert {f["rule"] for f in report["findings"]} == set(rules_torch.RULES)
    assert schema.validate_lint_report({"schema": "x"}) != []
    out = io.StringIO()
    assert lint_main(["--rules"], out=out) == 0
    catalog = out.getvalue()
    for rid in (set(rules_torch.RULES) | set(rules_grid.RULES)
                | set(rules_obs.RULES) | set(rules_conc.RULES)
                | set(rules_ir.RULES) | {"E001"}):
        assert re.search(rf"^{rid} ", catalog, re.M), rid
    assert "J101" not in catalog and "I501" not in catalog
    for argv, what in ((["lint", "--bogus"], "Unrecognized lint option"),
                       (["lint", "--backend", "cpu"], "--ir"),
                       (["audit", "--no-mesh"], "no mesh"),
                       (["bench", "--gate"], "ROADMAP")):
        with pytest.raises(ValueError, match=what):
            tmain.main(argv)


def test_port_lints_clean_with_reasons():
    out = io.StringIO()
    assert lint_main(["--json"], out=out) == 0
    report = json.loads(out.getvalue())
    assert report["findings"] == [] and report["counts"]["files"] >= 80
    n = 0
    for mod in Engine(PACKS).parse([PORT]):
        tokens = tokenize.generate_tokens(io.StringIO(mod.src).readline)
        for tok in tokens:
            m = re.search(r"#\s*f16lint:\s*disable\S*", tok.string)
            if tok.type != tokenize.COMMENT or not m:
                continue
            n += 1
            row = tok.start[0]
            reason = tok.string[m.end():].strip() or \
                mod.lines[row - 2].strip()
            assert reason.startswith(("(", "#")) and len(reason) > 8, (
                mod.path, row, tok.string)
    assert n == report["counts"]["suppressed_inline"] > 0


def test_analysis_imports_no_torch_or_jax():
    # The audit's recorder (ir.py) is the one module that imports torch;
    # only the audit imports it, lazily (tests/test_torch_audit.py).
    base = os.path.join(PORT, "analysis")
    for name in sorted(os.listdir(base)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(base, name)) as fd:
            tree = ast.parse(fd.read())
        banned = ("jax", "flake16_framework_tpu") if name == "ir.py" else \
            ("torch", "jax", "flake16_framework_tpu")
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import)
                    else [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in banned, (name, m)
