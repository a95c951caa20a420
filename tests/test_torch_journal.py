"""The port's write-ahead sweep journal and supervisor against the JAX
package's, on the CPU.

Unit tier, each case on both packages: record/replay round trip,
torn-tail truncation, the CRC cut, the fingerprint reset, writer-lock
exclusion with dead-pid takeover. Across the packages: a journal written
by either replays in the other to the same state, the run fingerprints are
equal, and a sweep killed in one package resumes in the other to the
uninterrupted run's scores. Integration tier: an in-process preemption at
a fold-append point, and the kill drill — a real SIGKILL delivered by the
journal (``F16_FAULT_INJECT=<config>:<fold>:sigkill``) to a child process
under the port's ``supervise``, whose restart resumes to counts equal to
the JAX package's uninterrupted ``write_scores``.
"""

import io
import json
import os
import pickle
import re
import signal
import struct
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from flake16_framework_tpu import pipeline as jpipe
from flake16_framework_tpu.data import load_tests as jload_tests
from flake16_framework_tpu.data import tests_to_arrays as jtests_to_arrays
from flake16_framework_tpu.parallel.sweep import SweepEngine as JSweepEngine
from flake16_framework_tpu.resilience import journal as jjournal
from flake16_framework_tpu_torch import config as tcfg
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
from flake16_framework_tpu_torch.resilience import inject, supervisor
from flake16_framework_tpu_torch.resilience import journal as tjournal
from flake16_framework_tpu_torch.utils.synth import make_tests_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOURNALS = {"jax": jjournal, "torch": tjournal}
BOTH = pytest.mark.parametrize("pkg", list(JOURNALS))
FP = ("schema", 1, "probe")

CONFIGS = [
    ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
    ("OD", "Flake16", "None", "Tomek Links", "Extra Trees"),
    ("NOD", "Flake16", "Scaling", "SMOTE", "Decision Tree"),
]
TINY = {"Extra Trees": 4, "Random Forest": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs several
    workers on the machine's cores, and a fold batch's tensors pass the
    size above which torch's CPU kernels split across threads, whose
    barriers then wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_x64_off(monkeypatch):
    """The JAX package as it runs in production, with 64-bit mode off (its
    keys, and so the journal's key bytes, depend on it)."""
    monkeypatch.setenv("F16_FAULT_BACKOFF_S", "0")
    monkeypatch.delenv(inject.ENV_VAR, raising=False)
    with jax.enable_x64(False):
        yield


def _folds(jr, keys, n=3):
    for f in range(n):
        jr.record_fold(keys, f, struct.pack("<II", 7, f),
                       np.full((2, 3, 3), f, np.int32))


def _idx(keys):
    return list(tcfg.iter_config_keys()).index(tuple(keys))


# -- record/replay, each package ----------------------------------------


@BOTH
def test_roundtrip_fold_and_config_records(tmp_path, pkg):
    rjournal = JOURNALS[pkg]
    path = str(tmp_path / "scores.pkl.journal")
    ka, kb = ("a",) * 5, ("b",) * 5
    with rjournal.SweepJournal.open(path, FP, warn_out=None) as jr:
        _folds(jr, ka, n=3)
        jr.record_config(ka, [0.1, 0.2, {"p": 1}, [3]])
        _folds(jr, kb, n=2)
        assert jr.n_appends == 7 and jr.append_wall_s > 0

    rep = rjournal.replay(path, fingerprint=FP, warn_out=None)
    assert not rep.truncated and rep.reset_reason is None
    assert rep.ledger == {ka: [0.1, 0.2, {"p": 1}, [3]]}
    assert set(rep.partial) == {kb} and set(rep.partial[kb]) == {0, 1}
    assert rep.n_partial_folds == 2
    key_bytes, counts = rep.partial[kb][1]
    assert key_bytes == struct.pack("<II", 7, 1)
    np.testing.assert_array_equal(counts, np.full((2, 3, 3), 1, np.int32))

    jr = rjournal.SweepJournal.open(path, FP, warn_out=None)
    assert jr.ledger == rep.ledger
    assert set(jr.partial_folds(kb)) == {0, 1}
    assert jr.partial_folds(("fresh",) * 5) == {}
    jr.finalize()
    assert not os.path.exists(path)
    assert not os.path.exists(rjournal.lock_path(path))


@BOTH
def test_torn_tail_truncated_on_reopen(tmp_path, pkg):
    rjournal = JOURNALS[pkg]
    path = str(tmp_path / "scores.pkl.journal")
    ka = ("a",) * 5
    with rjournal.SweepJournal.open(path, FP, warn_out=None) as jr:
        _folds(jr, ka, n=2)
    good_size = os.path.getsize(path)
    with open(path, "ab") as fd:  # length prefix promises 100 bytes...
        fd.write(struct.pack("<II", 100, 0) + b"xy")  # ...delivers 2
    warn = io.StringIO()
    rep = rjournal.replay(path, fingerprint=FP, warn_out=warn)
    assert rep.truncated and set(rep.partial[ka]) == {0, 1}
    assert rep.valid_end == good_size
    assert "torn tail" in warn.getvalue()

    with rjournal.SweepJournal.open(path, FP, warn_out=None) as jr:
        assert os.path.getsize(path) == good_size  # tail gone
        _folds(jr, ka, n=3)
    rep = rjournal.replay(path, fingerprint=FP, warn_out=None)
    assert not rep.truncated and set(rep.partial[ka]) == {0, 1, 2}


@BOTH
def test_corrupt_payload_cut_at_crc(tmp_path, pkg):
    rjournal = JOURNALS[pkg]
    path = str(tmp_path / "scores.pkl.journal")
    ka = ("a",) * 5
    with rjournal.SweepJournal.open(path, FP, warn_out=None) as jr:
        _folds(jr, ka, n=3)
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    rep = rjournal.replay(path, fingerprint=FP, warn_out=None)
    assert rep.truncated and set(rep.partial[ka]) == {0, 1}


@BOTH
def test_fingerprint_mismatch_resets(tmp_path, pkg):
    rjournal = JOURNALS[pkg]
    path = str(tmp_path / "scores.pkl.journal")
    with rjournal.SweepJournal.open(path, FP, warn_out=None) as jr:
        _folds(jr, ("a",) * 5, n=2)
    jr = rjournal.SweepJournal.open(path, ("other", 2), warn_out=None)
    assert jr.reset_reason == "fingerprint mismatch"
    assert jr.ledger == {} and jr.partial == {}
    _folds(jr, ("b",) * 5, n=1)
    jr.close()
    rep = rjournal.replay(path, fingerprint=("other", 2), warn_out=None)
    assert rep.reset_reason is None and set(rep.partial) == {("b",) * 5}
    with open(path, "wb") as fd:  # a first record that is not a header
        fd.write(rjournal._encode(("fold", ("a",) * 5, 0, b"", None)))
    assert rjournal.replay(path, warn_out=None).reset_reason == \
        "missing header"


@BOTH
def test_second_live_resumer_excluded(tmp_path, pkg):
    rjournal = JOURNALS[pkg]
    path = str(tmp_path / "scores.pkl.journal")
    jr = rjournal.SweepJournal.open(path, FP, warn_out=None)
    with pytest.raises(rjournal.JournalLocked, match="live pid"):
        rjournal.SweepJournal.open(path, FP, warn_out=None)
    jr.close()  # release WITHOUT removing: a later resume may continue
    rjournal.SweepJournal.open(path, FP, warn_out=None).close()
    assert os.path.exists(path)


@BOTH
def test_stale_lock_from_dead_pid_taken_over(tmp_path, pkg):
    rjournal = JOURNALS[pkg]
    path = str(tmp_path / "scores.pkl.journal")
    proc = subprocess.run(
        [sys.executable, "-c", "import os; print(os.getpid())"],
        capture_output=True, text=True)
    with open(rjournal.lock_path(path), "w") as fd:
        fd.write(str(int(proc.stdout)))
    jr = rjournal.SweepJournal.open(path, FP, warn_out=None)
    _folds(jr, ("a",) * 5, n=1)
    jr.close()
    with open(rjournal.lock_path(path), "w") as fd:
        fd.write("not-a-pid")  # garbage is stale too, never a deadlock
    rjournal.SweepJournal.open(path, FP, warn_out=None).close()


# -- across the packages ------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_journal_replays_across_packages(tmp_path, writer, reader):
    """A journal written by one package replays in the other to the same
    ledger and partial folds, and the files are byte-equal."""
    ka, kb = CONFIGS[0], CONFIGS[1]
    value = [0.1, 0.2, {"project00": [1, 2, 3, 0.5, 0.25, None]},
             [1, 2, 3, 0.5, 0.25, None]]
    paths = {}
    for name, rjournal in JOURNALS.items():
        paths[name] = str(tmp_path / f"{name}.journal")
        with rjournal.SweepJournal.open(paths[name], FP,
                                        warn_out=None) as jr:
            _folds(jr, ka, n=10)
            jr.record_config(ka, value)
            _folds(jr, kb, n=4)
    assert open(paths["jax"], "rb").read() == \
        open(paths["torch"], "rb").read()
    mine = JOURNALS[writer].replay(paths[writer], fingerprint=FP,
                                   warn_out=None)
    theirs = JOURNALS[reader].replay(paths[writer], fingerprint=FP,
                                     warn_out=None)
    assert theirs.reset_reason is None and not theirs.truncated
    assert theirs.ledger == mine.ledger == {ka: value}
    assert set(theirs.partial) == {kb} and set(theirs.partial[kb]) == \
        set(range(4))
    for f, (key_bytes, counts) in theirs.partial[kb].items():
        assert key_bytes == mine.partial[kb][f][0]
        np.testing.assert_array_equal(counts, mine.partial[kb][f][1])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A small tests.json and the JAX package's uninterrupted scores of
    ``CONFIGS`` on it (no journal)."""
    d = tmp_path_factory.mktemp("torch-journal")
    tj = str(d / "tests.json")
    make_tests_json(tj, n_tests=100, n_projects=3, seed=11)
    with jax.enable_x64(False):
        ref = jpipe.write_scores(tj, str(d / "jax-ref.pkl"), configs=CONFIGS,
                                 max_depth=8, tree_overrides=TINY,
                                 journal=False, progress_out=io.StringIO())
    return tj, ref


def _same_scores(got, ref):
    assert set(got) == set(CONFIGS)
    for k in CONFIGS:
        assert pickle.dumps(got[k][2:]) == pickle.dumps(ref[k][2:]), k


@pytest.mark.parametrize("cv", ["stratified", "lopo"])
def test_journal_fingerprint_matches_jax(data, cv):
    tj, _ = data
    kw = dict(cv=cv, max_depth=8, tree_overrides=TINY)
    jengine = JSweepEngine(*jtests_to_arrays(jload_tests(tj)),
                           max_depth=8, tree_overrides=TINY, cv=cv)
    tengine = SweepEngine(*tests_to_arrays(load_tests(tj)), max_depth=8,
                          tree_overrides=TINY, cv=cv, device="cpu")
    want = jpipe._journal_fingerprint(jengine, **kw)
    got = tpipe._journal_fingerprint(tengine, **kw)
    assert got == want
    assert pickle.dumps(("header", got)) == pickle.dumps(("header", want))


def _preempted(monkeypatch, rjournal, n_folds, run):
    """Run ``run()`` with a KeyboardInterrupt raised right after the
    ``n_folds``-th fold record is fsync'd: the program point where the
    kill drill delivers its SIGKILL."""
    calls = {"n": 0}
    orig = rjournal.SweepJournal.record_fold

    def preempting(self, *a, **k):
        out = orig(self, *a, **k)
        calls["n"] += 1
        if calls["n"] == n_folds:
            raise KeyboardInterrupt
        return out

    monkeypatch.setattr(rjournal.SweepJournal, "record_fold", preempting)
    with pytest.raises(KeyboardInterrupt):
        run()
    monkeypatch.setattr(rjournal.SweepJournal, "record_fold", orig)


def test_preempt_mid_config_resume_bit_identical(data, tmp_path,
                                                 monkeypatch):
    """Config 0 journaled complete, config 1 through fold 4, then resume:
    only the unfinished folds run again, with the journaled keys, and the
    scores equal the JAX package's uninterrupted run (v[2:]; v[:2] are
    wall clocks)."""
    tj, ref = data
    out = str(tmp_path / "scores.pkl")
    kw = dict(configs=CONFIGS, max_depth=8, tree_overrides=TINY,
              device="cpu")
    _preempted(monkeypatch, tjournal, 14, lambda: tpipe.write_scores(
        tj, out, progress_out=io.StringIO(), **kw))
    jpath = tjournal.journal_path(out)
    rep = tjournal.replay(jpath, warn_out=None)
    assert len(rep.ledger) == 1 and rep.n_partial_folds == 4
    assert not os.path.exists(tjournal.lock_path(jpath))

    fits = []
    orig = SweepEngine.run_config
    log = io.StringIO()
    monkeypatch.setattr(SweepEngine, "run_config",
                        lambda self, keys: fits.append(keys) or orig(self,
                                                                     keys))
    resumed = tpipe.write_scores(tj, out, progress_out=log, **kw)
    assert fits == CONFIGS[1:]
    assert "journal: replayed 1 completed config(s) and 4 partial " \
        "fold(s)" in log.getvalue()
    assert re.search(r"journal: \d+ appends in [0-9.]+ s", log.getvalue())
    _same_scores(resumed, ref)
    _same_scores(pickle.load(open(out, "rb")), ref)
    assert not os.path.exists(jpath)  # finalized


@pytest.mark.parametrize("killed,resumer", [("torch", "jax"),
                                            ("jax", "torch")])
def test_killed_sweep_resumes_in_the_other_package(data, tmp_path,
                                                   monkeypatch, killed,
                                                   resumer):
    """A sweep preempted in one package (config 0 complete, config 1
    through fold 3) resumes in the other: the other accepts the journal
    (equal fingerprints, equal key bytes) and finishes to the JAX
    package's uninterrupted scores."""
    tj, ref = data
    out = str(tmp_path / "scores.pkl")
    kw = dict(configs=CONFIGS, max_depth=8, tree_overrides=TINY)
    runs = {"jax": lambda log: jpipe.write_scores(tj, out, progress_out=log,
                                                  **kw),
            "torch": lambda log: tpipe.write_scores(
                tj, out, progress_out=log, device="cpu", **kw)}
    _preempted(monkeypatch, JOURNALS[killed], 13,
               lambda: runs[killed](io.StringIO()))
    log = io.StringIO()
    resumed = runs[resumer](log)
    assert "journal: replayed 1 completed config(s) and 3 partial " \
        "fold(s)" in log.getvalue()
    _same_scores(resumed, ref)
    assert not os.path.exists(tjournal.journal_path(out))


@pytest.mark.parametrize("killed,resumer", [("torch", "torch"),
                                            ("torch", "jax"),
                                            ("jax", "torch")])
def test_killed_planner_sweep_resumes_in_either_package(
        data, tmp_path, monkeypatch, killed, resumer):
    """Under ``planner`` (one plan a family: RF, then DT, then ET), a sweep
    preempted at a member's fold record (the RF member complete, the DT
    member through fold 2) resumes, in the same package or the other, to
    the JAX package's uninterrupted scores: both write the plan path's
    fold records with the same key bytes, and the resumer finishes the
    partial member fold by fold and runs the untouched plan."""
    tj, ref = data
    out = str(tmp_path / "scores.pkl")
    kw = dict(configs=CONFIGS, max_depth=8, tree_overrides=TINY,
              planner=True)
    one = Mesh(np.array(jax.devices()[:1]), ("config",))
    runs = {"jax": lambda log: jpipe.write_scores(tj, out, progress_out=log,
                                                  mesh=one, **kw),
            "torch": lambda log: tpipe.write_scores(
                tj, out, progress_out=log, device="cpu", **kw)}
    _preempted(monkeypatch, JOURNALS[killed], 13,
               lambda: runs[killed](io.StringIO()))
    rep = tjournal.replay(tjournal.journal_path(out), warn_out=None)
    assert list(rep.ledger) == [CONFIGS[0]]
    assert set(rep.partial) == {CONFIGS[2]} and \
        set(rep.partial[CONFIGS[2]]) == {0, 1, 2}
    log = io.StringIO()
    resumed = runs[resumer](log)
    assert "journal: replayed 1 completed config(s) and 3 partial " \
        "fold(s)" in log.getvalue()
    _same_scores(resumed, ref)
    assert not os.path.exists(tjournal.journal_path(out))


# -- the supervisor -----------------------------------------------------


CHILD = textwrap.dedent("""\
    import os, signal, sys
    marker = sys.argv[1]
    mode = sys.argv[2]
    spec = os.environ.get("F16_FAULT_INJECT", "")
    if not os.path.exists(marker):
        open(marker, "w").write(spec)
        if mode in ("die-once", "die-always"):
            os.kill(os.getpid(), signal.SIGKILL)
    elif mode == "die-always":
        os.kill(os.getpid(), signal.SIGKILL)
    open(marker + ".final", "w").write(spec)
    sys.exit(int(sys.argv[3]) if len(sys.argv) > 3 else 0)
    """)


def _child_argv(tmp_path, mode, *extra):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    return [sys.executable, str(script), str(tmp_path / "marker"), mode,
            *extra]


def test_supervise_restarts_signal_death_and_strips_chaos(tmp_path):
    env = dict(os.environ)
    env[inject.ENV_VAR] = "5:3:sigkill;7:1:transient"
    rc, history = supervisor.supervise(
        _child_argv(tmp_path, "die-once"), env=env, warn_out=None)
    assert rc == 0
    assert [h["signal"] for h in history] == [signal.SIGKILL]
    assert (tmp_path / "marker").read_text() == "5:3:sigkill;7:1:transient"
    assert (tmp_path / "marker.final").read_text() == "7:1:transient"


@pytest.mark.parametrize("code", [7, 23])
def test_supervise_nonzero_exit_not_restarted(tmp_path, code):
    rc, history = supervisor.supervise(
        _child_argv(tmp_path, "clean", str(code)), warn_out=None)
    assert rc == code and history == []
    assert (tmp_path / "marker.final").exists()


def test_supervise_restart_budget_exceeded(tmp_path):
    with pytest.raises(supervisor.RestartBudgetExceeded) as ei:
        supervisor.supervise(_child_argv(tmp_path, "die-always"),
                             max_restarts=2, warn_out=None)
    assert len(ei.value.history) == 3  # initial death + 2 restarted deaths
    assert all(h["signal"] == signal.SIGKILL for h in ei.value.history)


# -- the kill drill -----------------------------------------------------


DRILL = textwrap.dedent("""\
    import json, sys
    from flake16_framework_tpu_torch.pipeline import write_scores
    tests_file, out_file, configs, overrides = sys.argv[1:5]
    write_scores(tests_file, out_file,
                 configs=[tuple(c) for c in json.loads(configs)],
                 max_depth=8, tree_overrides=json.loads(overrides),
                 device="cpu")
    """)


def test_kill_drill_under_supervise(data, tmp_path):
    """A real SIGKILL right after the journal fsyncs fold 4 of the Extra
    Trees config, in a child process under ``supervise``: one death, one
    restart that replays the journal (1 completed config, 4 partial folds)
    and exits 0, and a pickle whose scores equal the JAX package's
    uninterrupted run's."""
    tj, ref = data
    out = str(tmp_path / "scores.pkl")
    env = dict(os.environ, PYTHONPATH=REPO,
               **{inject.ENV_VAR: f"{_idx(CONFIGS[1])}:4:sigkill"})
    log_path = tmp_path / "drill.log"
    with open(log_path, "w") as log:
        rc, history = supervisor.supervise(
            [sys.executable, "-c", DRILL, tj, out,
             json.dumps(CONFIGS), json.dumps(TINY)],
            env=env, cwd=str(tmp_path), stdout=log,
            stderr=subprocess.STDOUT, warn_out=None)
    text = log_path.read_text()
    assert rc == 0, text[-3000:]
    assert [h["signal"] for h in history] == [signal.SIGKILL]
    assert "journal: replayed 1 completed config(s) and 4 partial " \
        "fold(s)" in text
    _same_scores(pickle.load(open(out, "rb")), ref)
    assert not os.path.exists(tjournal.journal_path(out))
    assert not os.path.exists(tjournal.lock_path(tjournal.journal_path(out)))
