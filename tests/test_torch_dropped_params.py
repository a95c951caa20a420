"""Parameters of the JAX package's functions that the port's copies had
dropped, each held against its JAX counterpart on the CPU:
``SweepEngine.run_config(timings=)`` (the JAX stage names, scores the
same bits with and without), ``write_scores(journal=, checkpoint_every=)``
(the same checkpoint writes as the JAX function with the journal off; the
sweep itself stubbed, since only the writes are compared),
``supervise(backoff_s=, strip_chaos_on_restart=)``,
``data.load_feat_lab_proj``, ``make_tests_json(names=)`` and
``atomic_write(fsync=)``."""

import io
import os
import sys
import time

import jax
import numpy as np
import pytest

from flake16_framework_tpu import data as jdata
from flake16_framework_tpu import pipeline as jpipe
from flake16_framework_tpu.parallel import sweep as jsweep
from flake16_framework_tpu.resilience import supervisor as jsupervisor
from flake16_framework_tpu.utils import atomic as jatomic
from flake16_framework_tpu.utils import synth as jsynth
from flake16_framework_tpu_torch import data as tdata
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch.parallel import sweep as tsweep
from flake16_framework_tpu_torch.resilience import supervisor as tsupervisor
from flake16_framework_tpu_torch.utils import atomic as tatomic
from flake16_framework_tpu_torch.utils import synth as tsynth

# Every stage wall the JAX package's run_config(timings=) can fill.
JAX_STAGES = {"prep_s", "tree_keys_s", "chunks_s", "concat_s",
              "fit_total_s", "score_s", "counts_to_host_s"}


@pytest.fixture(autouse=True)
def _jax_x64_off():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def tests_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("params") / "tests.json")
    tsynth.make_tests_json(path, n_tests=120, n_projects=3, seed=4)
    return path


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_run_config_timings(tests_file, fused):
    keys = ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest")
    engine = tsweep.SweepEngine(
        *tdata.tests_to_arrays(tdata.load_tests(tests_file)), max_depth=4,
        tree_overrides={"Random Forest": 2}, device="cpu", fused=fused)
    plain = engine.run_config(keys)
    engine.fused_configs.clear()
    tm = {}
    timed = engine.run_config(keys, timings=tm)
    assert timed[2:] == plain[2:]
    assert {"fit_total_s", "score_s", "counts_to_host_s"} <= set(tm)
    assert set(tm) <= JAX_STAGES
    assert all(isinstance(v, float) and v >= 0 for v in tm.values())
    assert tm["fit_total_s"] >= tm["prep_s"]
    assert timed[1] > 0 and keys not in engine.fused_configs


def _stub_grid(monkeypatch, sweep_mod, n):
    """``run_grid`` of ``sweep_mod``'s engine stubbed to report ``n``
    configs through ``progress`` without fitting anything."""
    def run_grid(self, configs=None, ledger=None, progress=None, **kw):
        scores = dict(ledger or {})
        for i in range(1, n + 1):
            keys = ("NOD", "Flake16", "None", "None", f"m{i}")
            scores[keys] = [0.5, 0.25, {}, [1, 2, 3, 0.5, 0.5, 0.5]]
            progress(i, n, keys, scores)
        return scores

    monkeypatch.setattr(sweep_mod.SweepEngine, "run_grid", run_grid)


def _writes(monkeypatch, pipe_mod):
    """The pickle and sidecar writes ``pipe_mod.write_scores`` makes, in
    order: ("meta", configs stamped) and ("pickle", configs)."""
    log = []
    dump, meta = pipe_mod._dump, pipe_mod._write_timing_meta
    monkeypatch.setattr(pipe_mod, "_dump", lambda obj, path: (
        log.append(("pickle", len(obj))), dump(obj, path)))
    monkeypatch.setattr(pipe_mod, "_write_timing_meta", lambda *a: (
        log.append(("meta",)), meta(*a)))
    return log


@pytest.mark.parametrize("every", [1, 2, 12])
def test_write_scores_checkpoints_without_the_journal(
        tests_file, tmp_path, monkeypatch, every):
    _stub_grid(monkeypatch, jsweep, 5)
    _stub_grid(monkeypatch, tsweep, 5)
    jlog, tlog = _writes(monkeypatch, jpipe), _writes(monkeypatch, tpipe)
    kw = dict(journal=False, checkpoint_every=every,
              progress_out=io.StringIO())
    want = jpipe.write_scores(tests_file, str(tmp_path / "j.pkl"), **kw)
    got = tpipe.write_scores(tests_file, str(tmp_path / "t.pkl"),
                             device="cpu", **kw)
    assert got == want and tlog == jlog
    assert tlog.count(("pickle", 5)) == 1 + (5 % every == 0)
    assert not os.path.exists(tmp_path / "t.pkl.journal")
    # With the journal on, the port writes the pickle once, at the end.
    tlog.clear()
    tpipe.write_scores(tests_file, str(tmp_path / "tj.pkl"), device="cpu",
                       checkpoint_every=every, progress_out=io.StringIO())
    assert tlog == [("pickle", 5), ("meta",)]


CHILD = """
import os, signal, sys
with open(sys.argv[2], "a") as fd:
    fd.write(os.environ.get("F16_FAULT_INJECT", "-") + "\\n")
if not os.path.exists(sys.argv[1]):
    open(sys.argv[1], "w").close()
    os.kill(os.getpid(), signal.SIGKILL)
"""


@pytest.mark.parametrize("strip", [True, False])
def test_supervise_backoff_and_strip(tmp_path, monkeypatch, strip):
    env = dict(os.environ, F16_FAULT_INJECT="a/b:0:sigkill;c/d:1:transient")
    waits = []
    monkeypatch.setattr(time, "sleep", waits.append)
    seen = {}
    for name, mod in (("jax", jsupervisor), ("torch", tsupervisor)):
        d = tmp_path / name
        d.mkdir()
        rc, history = mod.supervise(
            [sys.executable, "-c", CHILD, str(d / "marker"), str(d / "log")],
            env=env, backoff_s=0.25, strip_chaos_on_restart=strip,
            warn_out=io.StringIO())
        assert rc == 0 and [h["signal"] for h in history] == [9]
        seen[name] = (d / "log").read_text().splitlines()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1] == ("c/d:1:transient" if strip
                                else env["F16_FAULT_INJECT"])
    assert waits == [0.25, 0.25]


def test_loader_names_and_fsync(tmp_path, monkeypatch):
    path = str(tmp_path / "tests.json")
    names = [f"subject-{i}" for i in range(4)]
    want = jsynth.make_tests_json(path, n_tests=60, n_projects=4, seed=2,
                                  names=names)
    assert tsynth.make_tests_json(n_tests=60, n_projects=4, seed=2,
                                  names=names) == want
    assert list(want) == names
    with pytest.raises(ValueError, match="3 names for 4 projects"):
        tsynth.make_tests_json(n_tests=60, n_projects=4, names=names[:3])
    for a, b in zip(tdata.load_feat_lab_proj(2, (0, 3, 9), path),
                    jdata.load_feat_lab_proj(2, (0, 3, 9), path)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    syncs = []
    monkeypatch.setattr(os, "fsync", syncs.append)
    for fsync in (True, False):
        counts = []
        for mod in (jatomic, tatomic):
            syncs.clear()
            with mod.atomic_write(str(tmp_path / "out.txt"), "w",
                                  fsync=fsync) as fd:
                fd.write("payload")
            counts.append(len(syncs))
            assert (tmp_path / "out.txt").read_text() == "payload"
        assert counts[0] == counts[1] == (2 if fsync else 0)
