"""The port's fault-tolerance layer (``flake16_framework_tpu_torch/
resilience/``) against the JAX package's, on the CPU: the checkpoint
ledger's tolerance of torn files, the classifier (the JAX package's table,
plus the CUDA runtime's errors and ``torch.OutOfMemoryError``), the
injection grammar, the backoff schedule, the dispatch guard, the
quarantine sidecar, and the injection drills through ``write_scores`` and
the command line. Where both packages have the code, each case runs both
and they must agree exactly. No test sleeps: the backoff is 0 or stubbed."""

import functools
import io
import json
import os
import pickle
import random

import jax
import pytest
import torch

from flake16_framework_tpu import pipeline as jpipe
from flake16_framework_tpu.resilience import faults as jfaults
from flake16_framework_tpu.resilience import guard as jguard
from flake16_framework_tpu.resilience import inject as jinject
from flake16_framework_tpu.resilience import quarantine as jquarantine
from flake16_framework_tpu_torch import __main__ as tmain
from flake16_framework_tpu_torch import config as tcfg
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
from flake16_framework_tpu_torch.resilience import faults as tfaults
from flake16_framework_tpu_torch.resilience import guard as tguard
from flake16_framework_tpu_torch.resilience import inject as tinject
from flake16_framework_tpu_torch.resilience import quarantine as tquarantine
from flake16_framework_tpu_torch.utils.synth import make_tests_json

PACKAGES = {
    "jax": (jfaults, jinject, jguard, jquarantine),
    "torch": (tfaults, tinject, tguard, tquarantine),
}
BOTH = pytest.mark.parametrize("pkg", list(PACKAGES))

CONFIGS = [
    ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
    ("OD", "Flake16", "None", "Tomek Links", "Extra Trees"),
    ("NOD", "Flake16", "Scaling", "SMOTE", "Decision Tree"),
]
TINY = {"Extra Trees": 4, "Random Forest": 4}


@pytest.fixture(autouse=True)
def _jax_x64_off(monkeypatch):
    """The JAX package as it runs in production, with 64-bit mode off, and
    no real backoff sleeps anywhere."""
    monkeypatch.setenv("F16_FAULT_BACKOFF_S", "0")
    monkeypatch.delenv(tinject.ENV_VAR, raising=False)
    with jax.enable_x64(False):
        yield


def _idx(keys):
    return list(tcfg.iter_config_keys()).index(tuple(keys))


# -- the checkpoint ledger (a torn scores.pkl) --------------------------


def _ledger_files(tmp_path):
    good = {("a",) * 5: [1.0, 2.0, {"p": [1, 2, 3]}, [1, 2, 3]],
            ("b",) * 5: [0.5, 0.25, {}, [0, 0, 0]]}
    blob = pickle.dumps(good)
    mixed = dict(good)
    mixed[("bad",) * 5] = [1.0, 2.0]          # not the 4-element schema
    return {"garbage": b"\x00garbag",          # 7 bytes
            "list": pickle.dumps([1, 2, 3]),
            "malformed": pickle.dumps(mixed),
            "truncated": blob[:len(blob) // 2]}


@pytest.mark.parametrize("name", ["garbage", "list", "malformed",
                                  "truncated"])
def test_load_ledger_matches_jax(tmp_path, name):
    out = str(tmp_path / "scores.pkl")
    with open(out, "wb") as fd:
        fd.write(_ledger_files(tmp_path)[name])
    jwarn, twarn = io.StringIO(), io.StringIO()
    want = jpipe._load_ledger(out, warn_out=jwarn)
    got = tpipe._load_ledger(out, warn_out=twarn)
    assert got == want
    assert jwarn.getvalue() and twarn.getvalue() == jwarn.getvalue()
    if name == "malformed":
        assert len(got) == 2 and "malformed" in twarn.getvalue()
    else:
        assert got == {}
    assert tpipe._load_ledger(str(tmp_path / "absent.pkl")) == {}


# -- the classifier -----------------------------------------------------


# The JAX package's table (tests/test_resilience.py): both packages agree.
JAX_TABLE = [
    ("UNAVAILABLE: TPU device error", "transient-device"),
    ("DEADLINE_EXCEEDED: stage bench timeout", "transient-device"),
    ("ABORTED: claim lost", "transient-device"),
    ("RESOURCE_EXHAUSTED: hbm oom", "oom"),
    ("Out of memory while trying to allocate 4096 bytes", "oom"),
    ("failed to allocate request for 2.0GiB", "oom"),
    ("no relay listener on :8082 (tunnel down; ss -tln)", "relay-down"),
    ("ValueError: shapes (3,) and (4,) not aligned", "deterministic"),
    ("INTERNAL: upstream said UNAVAILABLE in passing", "deterministic"),
    ("", "deterministic"),
    ("traceback...\nUNAVAILABLE: socket closed", "transient-device"),
]
# The CUDA runtime's errors as PyTorch raises them (the port only).
CUDA_TABLE = [
    ("CUDA out of memory. Tried to allocate 1024.00 GiB. GPU 0 has a total "
     "capacity of 79.19 GiB", "oom"),
    ("CUDA error: an illegal memory access was encountered\nCUDA kernel "
     "errors might be asynchronously reported at some other API call",
     "deterministic"),
    ("CUDA error: device-side assert triggered\nCompile with "
     "`TORCH_USE_CUDA_DSA` to enable device-side assertions.",
     "deterministic"),
    ("CUDA error: unspecified launch failure", "deterministic"),
    ("CUDA error: misaligned address", "deterministic"),
    ("CUDA error: uncorrectable ECC error encountered", "deterministic"),
    ("CUDA error: CUDA-capable device(s) is/are busy or unavailable",
     "transient-device"),
    # a sticky error stays deterministic whatever else the message says
    ("CUDA error: an illegal memory access was encountered (out of memory "
     "while unwinding)", "deterministic"),
    ("CUDA error: invalid argument", "deterministic"),
]


@pytest.mark.parametrize("message,expected,packages", [
    *[(m, e, ("jax", "torch")) for m, e in JAX_TABLE],
    *[(m, e, ("torch",)) for m, e in CUDA_TABLE],
])
def test_classify_message_table(message, expected, packages):
    for pkg in packages:
        assert PACKAGES[pkg][0].classify_message(message) == expected, pkg


@BOTH
def test_classify_exception_attribute_and_memoryerror(pkg):
    faults, inject, guard, _ = PACKAGES[pkg]
    assert faults.classify(faults.EnvelopeOverrun("x")) == \
        faults.ENVELOPE_OVERRUN
    assert faults.classify(MemoryError()) == faults.OOM
    assert faults.classify(RuntimeError("UNAVAILABLE: dead")) == \
        faults.TRANSIENT_DEVICE
    assert faults.classify(inject.InjectedFault("boom", faults.OOM)) == \
        faults.OOM
    e = guard.DispatchAbandoned("lbl", faults.OOM, [{"attempt": 1}],
                                RuntimeError("x"))
    assert faults.classify(e) == faults.OOM
    assert (faults.FAULT_CLASSES, faults.RETRYABLE) == \
        (jfaults.FAULT_CLASSES, jfaults.RETRYABLE)


def test_classify_torch_oom_by_type():
    """``torch.OutOfMemoryError`` is oom by its type, whatever its
    message; other torch errors go by their message."""
    assert tfaults.classify(torch.OutOfMemoryError("allocator gave up")) \
        == tfaults.OOM
    assert tfaults.classify(torch.cuda.OutOfMemoryError("x")) == tfaults.OOM
    assert jfaults.classify(torch.OutOfMemoryError("allocator gave up")) \
        == jfaults.DETERMINISTIC
    assert tfaults.classify(RuntimeError(
        "CUDA error: device-side assert triggered")) == tfaults.DETERMINISTIC


# -- the injection plan grammar -----------------------------------------


@BOTH
def test_parse_plan_grammar(pkg):
    faults, inject, _, _ = PACKAGES[pkg]
    p = inject.parse_plan("3:1:transient; 5:*:oom ;*:2:relay;"
                          "4:3:sigkill;1:2:worker-kill")
    assert p.entries == (
        (3, 1, faults.TRANSIENT_DEVICE), (5, None, faults.OOM),
        (None, 2, faults.RELAY_DOWN), (4, 3, "sigkill"),
        (1, 2, "worker-kill"))
    with pytest.raises(inject.InjectedFault) as ei:
        p.check(3, 1)
    assert ei.value.fault_class == faults.TRANSIENT_DEVICE
    p.check(3, 3)  # attempt mismatch: no-op
    p.check(4, 1)  # config mismatch: no-op
    p.check(4, 3)  # a process entry is not the guard's
    with pytest.raises(inject.InjectedFault) as ei2:
        p.check(9, 2)  # wildcard config
    assert ei2.value.fault_class == faults.RELAY_DOWN
    with pytest.raises(inject.InjectedFault):
        p.check(5, 7)  # wildcard attempt
    assert p.process_signal(4, 3) == 9 and p.process_signal(4, 2) is None
    assert p.process_signal(1, 2) is None  # worker entries are ignored
    assert inject.strip_process_entries(
        "4:3:sigkill; 7:1:transient;1:2:worker-kill") == "7:1:transient"
    assert inject.strip_process_entries("4:3:sigterm") == ""
    assert inject.plan_from_env({}) is None
    assert inject.plan_from_env({inject.ENV_VAR: "  "}) is None
    assert inject.plan_from_env({inject.ENV_VAR: "1:1:oom"}).entries == \
        ((1, 1, faults.OOM),)


@pytest.mark.parametrize("bad", [
    "3:1", "3:1:transient:extra", "x:1:oom", "3:0:oom", "3:1:nonsense",
])
@BOTH
def test_parse_plan_rejects_bad_grammar(pkg, bad):
    with pytest.raises(ValueError):
        PACKAGES[pkg][1].parse_plan(bad)


# -- the backoff policy -------------------------------------------------


def test_backoff_delays_match_jax():
    """One seeded rng: the same delays, jittered and not, in both."""
    for jitter in (0.0, 0.5):
        got = []
        for _, _, guard, _ in PACKAGES.values():
            pol = guard.BackoffPolicy(max_attempts=4, base_s=5.0, factor=2.0,
                                      max_s=60.0, jitter=jitter)
            rng = random.Random(0xF16)
            got.append([pol.delay_s(a, rng) for a in (1, 2, 3, 4, 5, 1, 2)])
        assert got[0] == got[1]
        if not jitter:
            assert got[1][:5] == [5.0, 10.0, 20.0, 40.0, 60.0]
        for a, d in zip((1, 2, 3, 4, 5, 1, 2), got[1]):
            base = min(60.0, 5.0 * 2.0 ** (a - 1))
            assert base <= d <= (1.0 + jitter) * base
    env = {"F16_FAULT_MAX_ATTEMPTS": "5", "F16_FAULT_BACKOFF_S": "2",
           "F16_FAULT_BACKOFF_MAX_S": "17"}
    for _, _, guard, _ in PACKAGES.values():
        pol = guard.policy_from_env(env)
        assert (pol.max_attempts, pol.base_s, pol.max_s) == (5, 2.0, 17.0)
        assert guard.policy_from_env({}).max_attempts == 3
        assert guard.policy_from_env({}).base_s == 5.0


# -- the dispatch guard -------------------------------------------------


def _guard(pkg, max_attempts=3, **kw):
    guard = PACKAGES[pkg][2]
    sleeps = []
    extra = {"block": False} if pkg == "jax" else {"device": "cpu"}
    g = guard.DispatchGuard(
        policy=guard.BackoffPolicy(max_attempts=max_attempts, base_s=5.0,
                                   factor=2.0, jitter=0.0),
        sleep=sleeps.append, **extra, **kw)
    return g, sleeps


@BOTH
def test_guard_retries_transient_then_recovers(pkg):
    g, sleeps = _guard(pkg)
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise RuntimeError("UNAVAILABLE: device error")
        return "ok"

    assert g.call(flaky, label="t") == "ok"
    assert calls[0] == 3
    assert sleeps == [5.0, 10.0]  # the backoff schedule, recorded not slept
    if pkg == "torch":
        assert [(r["attempt"], r["fault_class"], r["label"])
                for r in g.retries] == [(1, "transient-device", "t"),
                                        (2, "transient-device", "t")]


@BOTH
def test_guard_abandons_deterministic_immediately(pkg):
    guard = PACKAGES[pkg][2]
    g, sleeps = _guard(pkg)
    calls = [0]

    def broken():
        calls[0] += 1
        raise ValueError("shape mismatch")

    with pytest.raises(guard.DispatchAbandoned) as ei:
        g.call(broken, label="cfg/x")
    assert calls[0] == 1 and sleeps == []
    assert ei.value.fault_class == "deterministic"
    assert [a["attempt"] for a in ei.value.attempts] == [1]
    assert "shape mismatch" in str(ei.value)


@BOTH
def test_guard_exhausts_retries_then_abandons(pkg):
    guard = PACKAGES[pkg][2]
    g, sleeps = _guard(pkg, max_attempts=3)

    def always():
        raise RuntimeError("UNAVAILABLE: still dead")

    with pytest.raises(guard.DispatchAbandoned) as ei:
        g.call(always, label="cfg/y")
    assert ei.value.fault_class == "transient-device"
    assert [a["attempt"] for a in ei.value.attempts] == [1, 2, 3]
    assert len(sleeps) == 2  # no sleep after the final attempt


@BOTH
def test_guard_injected_fault_counts_as_attempt(pkg):
    guard, inject = PACKAGES[pkg][2], PACKAGES[pkg][1]
    extra = {"block": False} if pkg == "jax" else {"device": "cpu"}
    g = guard.DispatchGuard(
        policy=guard.BackoffPolicy(max_attempts=2, base_s=0.0, jitter=0.0),
        plan=inject.parse_plan("7:1:transient"), sleep=lambda s: None,
        **extra)
    calls = [0]
    out = g.call(lambda: calls.__setitem__(0, calls[0] + 1) or "ok",
                 config_index=7, label="drill")
    assert out == "ok" and calls[0] == 1  # attempt 1 injected, 2 ran


def test_guard_oom_retries_torch_oom():
    g, sleeps = _guard("torch")
    calls = [0]

    def oomy():
        calls[0] += 1
        if calls[0] < 2:
            raise torch.OutOfMemoryError("allocator gave up")
        return "fits"

    assert g.call(oomy, label="t") == "fits"
    assert [r["fault_class"] for r in g.retries] == ["oom"]
    assert sleeps == [5.0]


@BOTH
def test_guard_envelope_watchdog(pkg):
    import time as _time

    guard = PACKAGES[pkg][2]
    extra = {"block": False} if pkg == "jax" else {"device": "cpu"}
    g = guard.DispatchGuard(policy=guard.BackoffPolicy(max_attempts=1),
                            envelope_s=0.05, sleep=lambda s: None, **extra)
    with pytest.raises(guard.DispatchAbandoned) as ei:
        g.call(lambda: _time.sleep(1.0), label="slow")
    assert ei.value.fault_class == "envelope-overrun"
    # a thunk inside the envelope returns through the worker thread
    g = guard.DispatchGuard(policy=guard.BackoffPolicy(max_attempts=1),
                            envelope_s=30.0, **extra)
    assert g.call(lambda: "fast") == "fast"


def test_guard_runs_nothing_while_an_overrun_worker_lives():
    """The port does not retry an overrun in its process, though the
    class is retryable: the orphaned worker still runs. Every call made
    while it lives is abandoned without running; once it has ended, calls
    run again."""
    import threading

    release = threading.Event()
    ran = []

    def slow():
        ran.append("slow")
        release.wait(30)

    g = tguard.DispatchGuard(policy=tguard.BackoffPolicy(max_attempts=3),
                             envelope_s=0.05, sleep=lambda s: None,
                             device="cpu")
    for label in ("slow", "next"):
        with pytest.raises(tguard.DispatchAbandoned) as ei:
            g.call(slow if label == "slow" else (lambda: ran.append("next")),
                   label=label)
        assert ei.value.fault_class == "envelope-overrun"
        assert [a["attempt"] for a in ei.value.attempts] == [1]
    assert ran == ["slow"] and g.retries == []
    release.set()
    g._orphan.join(30)
    assert g.call(lambda: "fast") == "fast"


# -- the quarantine sidecar ---------------------------------------------


def test_sidecar_round_trip_merge_and_bytes(tmp_path):
    keys = ("OD", "Flake16", "None", "None", "Extra Trees")
    other = ("NOD", "Flake16", "PCA", "SMOTE", "Random Forest")
    entries = {keys: {"fault_class": "transient-device",
                      "attempts": [{"attempt": 1, "error": "x",
                                    "fault_class": "transient-device"}]}}
    paths = {}
    for name, (_, _, _, quarantine) in PACKAGES.items():
        path = str(tmp_path / f"{name}.quarantine.json")
        quarantine.save_sidecar(path, entries)
        paths[name] = path
    # byte-equal files, each readable by the other package
    blobs = [open(p, "rb").read() for p in paths.values()]
    assert blobs[0] == blobs[1]
    assert tquarantine.load_sidecar(paths["jax"]) == entries
    assert jquarantine.load_sidecar(paths["torch"]) == entries
    path = paths["torch"]
    merged = tquarantine.update_sidecar(
        path, {other: {"fault_class": "oom", "attempts": []}})
    assert set(merged) == {keys, other}
    assert set(tquarantine.update_sidecar(path, {}, completed=[keys])) == \
        {other}
    assert tquarantine.update_sidecar(path, {}, completed=[other]) == {}
    assert tquarantine.load_sidecar(path) == {}
    assert json.load(open(path))["schema"] == jquarantine.SIDECAR_SCHEMA
    assert tquarantine.load_sidecar(str(tmp_path / "nope.json")) == {}
    bad = tmp_path / "bad.json"
    bad.write_text("{torn")
    assert tquarantine.load_sidecar(str(bad)) == {}


def test_quarantined_configs_exit_code():
    e = tquarantine.QuarantinedConfigs(
        {("OD", "Flake16", "None", "None", "Extra Trees"):
         {"fault_class": "oom", "attempts": []}}, scores={"k": 1})
    assert isinstance(e, SystemExit)
    assert e.code == tquarantine.QUARANTINE_EXIT_CODE == 23
    assert tquarantine.QUARANTINE_EXIT_CODE == \
        jquarantine.QUARANTINE_EXIT_CODE
    assert str(e) == str(jquarantine.QuarantinedConfigs(e.quarantined))


# -- injection drills through the sweep ---------------------------------


@pytest.fixture(scope="module")
def sweep_dir(tmp_path_factory):
    """A small tests.json and the port's uninterrupted, fault-free scores
    of ``CONFIGS`` on it."""
    d = tmp_path_factory.mktemp("torch-resilience")
    tj = str(d / "tests.json")
    make_tests_json(tj, n_tests=100, n_projects=3, seed=11)
    ref = tpipe.write_scores(tj, str(d / "ref.pkl"), configs=CONFIGS,
                             max_depth=8, tree_overrides=TINY, device="cpu",
                             progress_out=io.StringIO())
    return d, ref


def _same_scores(got, ref, configs):
    assert set(got) == set(configs)
    for k in configs:
        assert pickle.dumps(got[k][2:]) == pickle.dumps(ref[k][2:]), k


def test_injected_transient_and_oom_sweep_completes(sweep_dir, monkeypatch):
    """A transient fault and an OOM on two configs: each is retried once,
    no config is quarantined, and the scores equal the fault-free run's
    (a retry is bit-identical)."""
    d, ref = sweep_dir
    monkeypatch.setenv(tinject.ENV_VAR, f"{_idx(CONFIGS[0])}:1:transient;"
                       f"{_idx(CONFIGS[1])}:1:oom")
    engine = SweepEngine(*tests_to_arrays(load_tests(str(d / "tests.json"))),
                         max_depth=8, tree_overrides=TINY, device="cpu")
    got = engine.run_grid(CONFIGS)
    _same_scores(got, ref, CONFIGS)
    assert engine.quarantined == {}
    assert [(r["label"], r["attempt"], r["fault_class"])
            for r in engine.retries] == [
        ("/".join(CONFIGS[0]), 1, "transient-device"),
        ("/".join(CONFIGS[1]), 1, "oom")]


def test_deterministic_fault_quarantines_at_once(sweep_dir):
    """A config whose run raises (here: a bad config key) is quarantined
    after one attempt, and the sweep goes on."""
    d, ref = sweep_dir
    engine = SweepEngine(*tests_to_arrays(load_tests(str(d / "tests.json"))),
                         max_depth=8, tree_overrides=TINY, device="cpu")
    bad = ("NOD", "Flake16", "Scaling", "SMOTE", "Gradient Boosting")
    got = engine.run_grid([CONFIGS[2], bad])
    _same_scores(got, ref, CONFIGS[2:])
    assert list(engine.quarantined) == [bad]
    rec = engine.quarantined[bad]
    assert rec["fault_class"] == "deterministic"
    assert [a["attempt"] for a in rec["attempts"]] == [1]


def test_injected_quarantine_exit_23_then_resume(sweep_dir, tmp_path,
                                                 monkeypatch):
    """One config fails every attempt: ``scores`` on the command line
    finishes the sweep, writes the others, records the config in the
    sidecar and exits with 23. ``resume`` then runs only that config and
    clears the sidecar; the scores equal the fault-free run's."""
    d, ref = sweep_dir
    monkeypatch.chdir(tmp_path)
    make_tests_json("tests.json", n_tests=100, n_projects=3, seed=11)
    doomed = CONFIGS[1]
    monkeypatch.setenv(tinject.ENV_VAR, f"{_idx(doomed)}:*:transient")
    log = io.StringIO()
    monkeypatch.setattr(tpipe, "write_scores", functools.partial(
        tpipe.write_scores, configs=CONFIGS, max_depth=8,
        tree_overrides=TINY, device="cpu", progress_out=log))
    with pytest.raises(ValueError, match="no resume state"):
        tmain.main(["resume"])
    with pytest.raises(SystemExit) as ei:
        tmain.main(["scores"])
    assert ei.value.code == 23
    assert set(ei.value.quarantined) == {doomed}
    on_disk = pickle.load(open("scores.pkl", "rb"))
    _same_scores(on_disk, ref, [k for k in CONFIGS if k != doomed])
    entries = tquarantine.load_sidecar("scores.pkl.quarantine.json")
    assert set(entries) == {doomed}
    assert entries[doomed]["fault_class"] == "transient-device"
    assert [a["attempt"] for a in entries[doomed]["attempts"]] == [1, 2, 3]
    assert f"QUARANTINED {'/'.join(doomed)} [transient-device] after 3 " \
        "attempt(s)" in log.getvalue()
    assert not os.path.exists("scores.pkl.journal")
    # the JAX package reads the port's sidecar the same
    assert jquarantine.load_sidecar("scores.pkl.quarantine.json") == entries

    monkeypatch.delenv(tinject.ENV_VAR)
    ran = []
    orig = SweepEngine.run_config
    monkeypatch.setattr(SweepEngine, "run_config",
                        lambda self, keys: ran.append(keys) or orig(self,
                                                                    keys))
    tmain.main(["resume"])
    assert ran == [doomed]
    _same_scores(pickle.load(open("scores.pkl", "rb")), ref, CONFIGS)
    assert tquarantine.load_sidecar("scores.pkl.quarantine.json") == {}


def test_overrun_under_the_sweep_quarantines_then_resume(sweep_dir,
                                                         tmp_path,
                                                         monkeypatch):
    """A config that overruns the watchdog under ``write_scores`` with its
    journal: it and every config after it are quarantined after one
    attempt, and none of the later ones runs while the orphaned worker
    lives (no second ``run_config`` beside it on the engine and journal).
    A ``resume`` in the same directory then completes every config, equal
    to the fault-free run's scores."""
    import threading

    d, ref = sweep_dir
    out = str(tmp_path / "scores.pkl")
    release = threading.Event()
    ran, workers = [], []
    orig = SweepEngine.run_config

    def run_config(self, keys):
        ran.append(keys)
        if not release.is_set():
            workers.append(threading.current_thread())
            release.wait(30)
            return None
        return orig(self, keys)

    monkeypatch.setattr(SweepEngine, "run_config", run_config)
    monkeypatch.setenv("F16_FAULT_ENVELOPE_S", "0.2")
    run = functools.partial(tpipe.write_scores, str(d / "tests.json"), out,
                            configs=CONFIGS, max_depth=8,
                            tree_overrides=TINY, device="cpu",
                            progress_out=io.StringIO())
    with pytest.raises(tquarantine.QuarantinedConfigs) as ei:
        run()
    assert ei.value.code == 23
    assert ran == CONFIGS[:1]
    assert set(ei.value.quarantined) == set(CONFIGS)
    for rec in ei.value.quarantined.values():
        assert rec["fault_class"] == "envelope-overrun"
        assert [a["attempt"] for a in rec["attempts"]] == [1]
    assert pickle.load(open(out, "rb")) == {}
    assert not os.path.exists(out + ".journal")
    release.set()
    workers[0].join(30)

    monkeypatch.delenv("F16_FAULT_ENVELOPE_S")
    ran.clear()
    _same_scores(run(), ref, CONFIGS)
    assert ran == CONFIGS
    assert tquarantine.load_sidecar(out + ".quarantine.json") == {}


def test_cli_rejects_options_of_later_slices():
    for command in ("scores", "resume"):
        with pytest.raises(ValueError, match="telemetry"):
            tmain.main([command, "profile=/tmp/x"])
        with pytest.raises(ValueError, match="Unrecognized"):
            tmain.main([command, "bogus"])
