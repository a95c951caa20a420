"""The port's concurrency model (``analysis/concurrency.py``), its C pack
(``analysis/rules_conc.py``) and the witness's reconciliation against
the static model (``obs/lockwatch.reconcile``), against the JAX
package's on the same sources, on the CPU.

Held: the thread topology, lock census (ids, creation sites), order
edges, cycles and shared writes of both models on synthetic modules,
the JAX package's seeded fixture, and the port's sources; the lock
model (``build_lock_model``) of both on the same sources; the C findings
of both engines on seeded inversions; the port's ``lint --concurrency``
clean; the witness, armed around an in-process serving drill on the
CPU, reconciled against the port's real static model with no cycle and
no violation, a witnessed child that heals a torn performance database
under telemetry checked on its one edge between modeled locks, and an
edge that the model orders the other way round flagged as inverted — by
the port's and the JAX package's ``reconcile`` alike."""

import io
import json
import os
import sys
import threading

import jax
import pytest

from flake16_framework_tpu.analysis import Engine as JEngine
from flake16_framework_tpu.analysis import Module as JModule
from flake16_framework_tpu.analysis import concurrency as jconc
from flake16_framework_tpu.analysis import rules_conc as jrules_conc
from flake16_framework_tpu.obs import lockwatch as jlockwatch
from flake16_framework_tpu_torch.analysis import Engine
from flake16_framework_tpu_torch.analysis import concurrency as conc
from flake16_framework_tpu_torch.analysis import rules_conc
from flake16_framework_tpu_torch.analysis.cli import lint_main
from flake16_framework_tpu_torch.obs import lockwatch, schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "lint_fixtures",
                       "fixture_violations.py")
PORT = os.path.join(REPO, "flake16_framework_tpu_torch")

SYNTH = '''\
import signal
import threading

_lock = threading.Lock()
_other = threading.RLock()
_shared = {"n": 0}


class Worker:
    def __init__(self):
        self._cond = threading.Condition()
        self._runner = threading.Thread(target=self._run, name="w")

    def start(self):
        self._runner.start()

    def _run(self):
        with self._cond:
            with _lock:
                _shared["n"] = _shared["n"] + 1


def _tick():
    with _lock:
        _grab()


def _grab():
    with _other:
        pass


def arm():
    threading.Timer(1.0, _tick).start()
    signal.signal(signal.SIGTERM, _handler)


def _handler(signum, frame):
    pass


def fan_out():
    for _ in range(4):
        threading.Thread(target=_tick).start()


def reset():
    global _shared
    _shared = {"n": 0}
'''

INVERSION = '''\
import threading

_front = threading.Lock()
_back = threading.Lock()


def _grab_back():
    with _back:
        pass


def _forward():
    with _front:
        _grab_back()


def _backward():
    with _back:
        with _front:
            pass


def spawn():
    threading.Thread(target=_forward).start()
    threading.Thread(target=_backward).start()
'''


@pytest.fixture(autouse=True)
def _in_repo(monkeypatch):
    """Paths relative to the repository; 64-bit mode off."""
    monkeypatch.chdir(REPO)
    with jax.enable_x64(False):
        yield


def _project_view(proj):
    """Everything a project build derives, as plain data."""
    roots = sorted((r.key, r.kind, r.target, r.multi, r.name)
                   for mm in proj.mods.values() for r in mm.roots)
    return {
        "locks": {lid: (ld.site, ld.kind)
                  for lid, ld in proj.lock_defs.items()},
        "edges": sorted(proj.edges),
        "cycles": proj.cycles(),
        "roots": roots,
        "reach": {k: sorted(v) for k, v in sorted(proj.reach.items())},
        "writes": {k: sorted((fk, w.node.lineno, w.held) for fk, w in v)
                   for k, v in sorted(proj.shared_writes().items())},
    }


def _sources(tmp_path, case):
    if case in ("synth", "inversion"):
        path = tmp_path / f"{case}.py"
        path.write_text(SYNTH if case == "synth" else INVERSION)
        return [str(path)]
    return {"fixture": [FIXTURE], "port": [PORT]}[case]


@pytest.mark.parametrize("case", ["synth", "inversion", "fixture", "port"])
def test_model_equal_jax(tmp_path, case):
    paths = _sources(tmp_path, case)
    mods = Engine(()).parse(paths)
    jmods = [JModule(m.path, src=m.src) for m in mods]
    view = _project_view(conc.build_project(mods))
    assert view == _project_view(jconc.build_project(jmods))
    model = conc.build_lock_model(paths)
    assert model == jconc.build_lock_model(paths)
    assert json.loads(json.dumps(model)) == model
    if case == "synth":
        assert sorted(model["locks"]) == [
            f"{mods[0].path}:{n}" for n in (
                "Worker._cond", "_lock", "_other")]
        assert [mods[0].path + ":_lock", mods[0].path + ":_other"] in \
            model["edges"]
        assert view["cycles"] == []
    if case == "inversion":
        assert len(view["cycles"]) == 1
    if case == "port":
        sites = {v["site"].rpartition(":")[0] for v in
                 model["locks"].values()}
        for module in ("kernels/build.py", "obs/core.py",
                       "serve/batcher.py", "serve/queue.py"):
            assert f"flake16_framework_tpu_torch/{module}" in sites


@pytest.mark.parametrize("case", ["synth", "inversion", "fixture"])
def test_c_findings_equal_jax(tmp_path, case):
    paths = _sources(tmp_path, case)
    got = Engine((rules_conc,)).lint(paths).findings
    want = JEngine((jrules_conc,)).lint(paths).findings
    assert [(f.rule, f.path, f.line, f.message) for f in got] == \
        [(f.rule, f.path, f.line, f.message) for f in want]
    rules = [f.rule for f in got]
    if case == "inversion":
        assert rules == ["C201"] and "_front" in got[0].message
    elif case == "fixture":
        assert set(rules) == set(rules_conc.RULES)


def test_concurrency_gate_port_is_clean():
    out = io.StringIO()
    assert lint_main(["--concurrency", "--json"], out=out) == 0
    report = json.loads(out.getvalue())
    assert schema.validate_lint_report(report) == []
    assert report["findings"] == []
    assert report["packs"] == ["concurrency", "engine"]
    assert set(rules_conc.RULES) <= set(report["rules"])


@pytest.fixture
def traced():
    lockwatch.reset()
    lockwatch.install()
    yield
    lockwatch.uninstall()
    lockwatch.reset()


def test_witness_flags_an_inverted_edge(tmp_path, traced):
    path = tmp_path / "lw_inv.py"
    path.write_text("import threading\n\n_a = threading.Lock()\n"
                    "_b = threading.Lock()\n\n\ndef ordered():\n"
                    "    with _a:\n        with _b:\n            pass\n")
    sys.path.insert(0, str(tmp_path))
    try:
        import lw_inv
    finally:
        sys.path.remove(str(tmp_path))
    try:
        lw_inv.ordered()
        snap = lockwatch.snapshot()
        model = conc.build_lock_model([str(path)])
        ida, idb = sorted(model["locks"])
        rec = lockwatch.reconcile(snap, model)
        assert rec == jlockwatch.reconcile(snap, model)
        assert rec["ok"] and rec["known_locks"] == [ida, idb]
        with lw_inv._b:
            with lw_inv._a:
                pass
        snap = lockwatch.snapshot()
        rec = lockwatch.reconcile(snap, model)
        assert rec == jlockwatch.reconcile(snap, model)
        assert not rec["ok"]
        assert rec["cycle"] is not None
        assert rec["violations"] == [{"edge": [idb, ida],
                                      "why": "inverted"}]
    finally:
        del sys.modules["lw_inv"]


def test_serving_drill_reconciles_against_the_static_model(tmp_path):
    """The witness armed around an in-process serving drill on the CPU
    (the service's locks are minted after install, so the queue's
    condition, the batcher's and the service's locks are traced), the
    observed graph reconciled against the port's static model."""
    from flake16_framework_tpu_torch.serve import (
        ModelRegistry, ScoringService,
    )
    from flake16_framework_tpu_torch.utils.synth import make_dataset

    feats, labels, _ = make_dataset(n_tests=120, seed=7)
    keys = ("NOD", "Flake16", "None", "None", "Decision Tree")
    lockwatch.reset()
    lockwatch.install()
    try:
        reg = ModelRegistry(str(tmp_path), device="cpu")
        model = reg.fit_and_register(keys, feats, labels, max_depth=4,
                                     seed=3)
        svc = ScoringService(reg, buckets=(4, 16), device="cpu")
        svc.start()
        try:
            threads = [threading.Thread(target=svc.score, args=(
                model.model_id, feats[i:i + 3]), kwargs={"timeout": 60})
                for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            out = svc.score(model.model_id, feats[:3], kind="predict",
                            timeout=60)
            assert out.shape[0] == 3
        finally:
            svc.stop()
        snap = lockwatch.snapshot()
    finally:
        lockwatch.uninstall()
        lockwatch.reset()

    static = conc.build_lock_model([PORT])
    rec = lockwatch.reconcile(snap, static)
    assert rec == jlockwatch.reconcile(snap, static)
    assert rec["cycle"] is None and rec["violations"] == [], rec
    assert rec["ok"]
    assert len(rec["known_locks"]) >= 3, rec["known_locks"]
    assert any(k.split(":")[0].endswith(("serve/queue.py",
                                         "serve/batcher.py",
                                         "serve/service.py"))
               for k in rec["known_locks"]), rec["known_locks"]


# A witnessed child: telemetry on, one row appended to a performance
# database whose tail a dying writer tore.
RECOVERY_CHILD = """
import sys
from flake16_framework_tpu_torch import obs
from flake16_framework_tpu_torch.obs import perfdb
obs.configure(sys.argv[2])
row = perfdb.make_row("cuda", "drill", "config.drill", {"fit_s": 1.0},
                      src="lockwatch-drill", ts=1.0)
print(perfdb.append([row], path=sys.argv[1]), "torch" in sys.modules)
obs.shutdown()
"""


def test_perfdb_recovery_drill_checks_a_modeled_edge(tmp_path):
    """``perfdb.append`` heals the torn tail under ``_append_lock`` and
    emits the truncation under ``obs/core``'s ``_lock``: the witness's
    dump holds that edge, which both packages' ``reconcile`` check
    against the port's static model and find in its order."""
    import subprocess

    from flake16_framework_tpu_torch.obs import perfdb

    db, dump = tmp_path / "perfdb.jsonl", tmp_path / "lockwatch.json"
    db.write_text('{"schema": "flake16-perfdb-v1", "backend": "cu')
    proc = subprocess.run(
        [sys.executable, "-c", RECOVERY_CHILD, str(db),
         str(tmp_path / "telemetry")], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO,
                 **{lockwatch.ENV_VAR: str(dump)}),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1", "False"]
    assert len(perfdb.load(str(db))) == 1
    snap = json.loads(dump.read_text())
    static = conc.build_lock_model([PORT])
    rec = lockwatch.reconcile(snap, static, root=REPO)
    assert rec == jlockwatch.reconcile(snap, static, root=REPO)
    assert rec["ok"] and rec["checked_edges"] == 1, rec
    assert {"flake16_framework_tpu_torch/obs/perfdb.py:_append_lock",
            "flake16_framework_tpu_torch/obs/core.py:_lock"} <= set(
                rec["known_locks"])
