"""The port's orchestration layer (``runner/containers.py``, ``pool.py``)
against the JAX package's: the same ``Recorder``/``FakeProc`` fakes drive
both, and the transcripts, ledgers, stdout files, exit codes and progress
bytes must be equal. The only differences allowed are the two the port's
module docstring states, and the tests assert exactly those: the module
``docker_command`` runs, and the plugin selection (``PLUGIN_SELECT``)
after the blacklist in the pytest command."""

import functools
import io
import os
import pickle
import shutil
import subprocess as sp

import pytest

from flake16_framework_tpu import constants as jconst
from flake16_framework_tpu.runner import containers as JR
from flake16_framework_tpu.runner import pool as jpool
from flake16_framework_tpu.runner import subjects as jsubjects
from flake16_framework_tpu_torch import __main__ as tmain
from flake16_framework_tpu_torch import constants as tconst
from flake16_framework_tpu_torch.runner import containers as TR
from flake16_framework_tpu_torch.runner import pool as tpool
from flake16_framework_tpu_torch.runner import subjects as tsubjects

SUBJECT = "o/p,abc123,src,python prep.py,pytest -x"


class FakeProc:
    def __init__(self, returncode=0):
        self.returncode = returncode


class Recorder:
    def __init__(self, fail_names=()):
        self.calls = []
        self.fail_names = fail_names

    def __call__(self, cmd, **kw):
        # stdout is an open file: record its name, not the object
        kw = {k: (v.name if k == "stdout" else v) for k, v in kw.items()}
        self.calls.append((list(cmd), kw))
        rc = 1 if any(n in " ".join(cmd) for n in self.fail_names) else 0
        return FakeProc(rc)


def _without_select(cmd):
    """The port's pytest command with ``PLUGIN_SELECT`` taken out, which
    must stand right after the blacklist."""
    i = cmd.index("--set-exitstatus") - len(TR.PLUGIN_SELECT)
    assert tuple(cmd[i:i + len(TR.PLUGIN_SELECT)]) == TR.PLUGIN_SELECT
    assert tuple(cmd[i - len(TR.PLUGIN_BLACKLIST):i]) == TR.PLUGIN_BLACKLIST
    return cmd[:i] + cmd[i + len(TR.PLUGIN_SELECT):]


def _jax_module(cmd):
    """A docker command with the port's module name put back to the JAX
    package's; exactly one token differs."""
    out = ["flake16_framework_tpu" if a == "flake16_framework_tpu_torch"
           else a for a in cmd]
    assert sum(a != b for a, b in zip(cmd, out)) == 1
    return out


def test_constants_equal_the_jax_package():
    for name in ("LOG_FILE", "TESTS_FILE", "REQUIREMENTS_FILE", "DATA_DIR",
                 "STDOUT_DIR", "WORK_DIR", "SUBJECTS_DIR", "CONT_DATA_DIR",
                 "CONT_TIMEOUT", "PIP_VERSION", "IMAGE_NAME", "PIP_INSTALL",
                 "N_RUNS", "PLUGIN_BLACKLIST", "FRAMEWORK_DIR", "PLUGINS"):
        assert getattr(tconst, name) == getattr(jconst, name), name


@pytest.mark.parametrize("name,commands", [
    ("proj_shuffle_7", ("python prep.py", "pytest -x")),
    ("proj_baseline_0", ("pytest -q tests",)),
    ("proj_testinspect_0", ("cp a b", "python setup.py x", "pytest")),
])
def test_container_entrypoint_matches_jax(name, commands):
    want, got = Recorder(), Recorder()
    JR.container_entrypoint(name, *commands, exec_fn=want)
    TR.container_entrypoint(name, *commands, exec_fn=got)
    assert len(got.calls) == len(want.calls) == len(commands)
    assert got.calls[:-1] == want.calls[:-1]     # setup commands
    (cmd, kw), (jcmd, jkw) = got.calls[-1], want.calls[-1]
    assert _without_select(cmd) == jcmd
    assert kw == jkw and kw["timeout"] == tconst.CONT_TIMEOUT
    assert TR.PLUGIN_SELECT == (
        "-p", "no:showflakes", "-p", "no:testinspect",
        "-p", "flake16_framework_tpu_torch.plugins.showflakes",
        "-p", "flake16_framework_tpu_torch.plugins.testinspect")


def test_docker_command_differs_only_in_the_module():
    cmd = TR.docker_command("p_baseline_3", ("a", "pytest"), "/host/data")
    assert _jax_module(cmd) == JR.docker_command(
        "p_baseline_3", ("a", "pytest"), "/host/data")
    assert cmd[cmd.index("-m") + 1] == "flake16_framework_tpu_torch"


@pytest.mark.parametrize("modes", [["baseline"], ["testinspect"],
                                   ["shuffle", "testinspect", "shuffle"]])
def test_enumerate_containers_matches_jax(modes):
    s = [tsubjects.parse_subject_line(SUBJECT)]
    js = [jsubjects.parse_subject_line(SUBJECT)]
    got = list(TR.enumerate_containers(modes, subjects=s))
    assert got == list(JR.enumerate_containers(modes, subjects=js))
    assert got[0] == (f"p_{sorted(set(modes))[0]}_0", s[0].commands)
    # the packaged registry, from the working directory
    assert list(TR.enumerate_containers(modes)) == list(
        JR.enumerate_containers(modes))


def _fresh(path, monkeypatch):
    """An empty working directory at ``path``: both packages run in the
    same one, in turn, so their absolute paths agree."""
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir()
    monkeypatch.chdir(path)


def test_launch_container_matches_jax(tmp_path, monkeypatch):
    transcripts = []
    for R in (JR, TR):
        _fresh(tmp_path / "w", monkeypatch)
        os.mkdir("stdout")
        rec = Recorder(fail_names=["p_shuffle_1"])
        out = [R.launch_container(("p_shuffle_1", ("pytest",)), exec_fn=rec),
               R.launch_container(("p_shuffle_2", ("a", "pytest -q")),
                                  exec_fn=rec)]
        transcripts.append((out, rec.calls, sorted(os.listdir("stdout"))))
    (jout, jcalls, jfiles), (tout, tcalls, tfiles) = transcripts
    assert tout == jout == [("failed: p_shuffle_1", (False, "p_shuffle_1")),
                            ("succeeded: p_shuffle_2", (True, "p_shuffle_2"))]
    assert tfiles == jfiles == ["p_shuffle_1", "p_shuffle_2"]
    assert [(_jax_module(c), kw) for c, kw in tcalls] == jcalls
    assert tcalls[1][1] == {"stdout": os.path.join("stdout", "p_shuffle_2")}


@pytest.mark.parametrize("fail", [(), ("p_baseline_2",)])
def test_run_experiment_matches_jax(tmp_path, monkeypatch, fail):
    """Resume from ``log.txt``, the ledger of successes, stdout per
    container and the exit status, in both packages."""
    monkeypatch.setitem(jconst.N_RUNS, "baseline", 3)
    monkeypatch.setitem(tconst.N_RUNS, "baseline", 3)
    results = []
    for R, S, pool in ((JR, jsubjects, jpool), (TR, tsubjects, tpool)):
        _fresh(tmp_path / "w", monkeypatch)
        with open("log.txt", "w") as fd:
            fd.write("p_baseline_0\n")
        rec, codes, out = Recorder(fail_names=fail), [], io.StringIO()
        R.run_experiment(
            ["baseline", "testinspect"],
            subjects=[S.parse_subject_line("o/p,sha,dir,pytest")],
            exec_fn=rec, exit_fn=codes.append,
            pool_kwargs={"pool_factory": pool.SerialPool, "out": out,
                         "seed": 0})
        with open("log.txt") as fd:
            ledger = fd.read()
        results.append((rec.calls, codes, ledger,
                        sorted(os.listdir("stdout")), out.getvalue()))
    (jcalls, jcodes, jledger, jout, jprog) = results[0]
    (tcalls, tcodes, tledger, tout, tprog) = results[1]
    assert tcodes == jcodes == [1 if fail else 0]
    assert tledger == jledger                      # same lines, same order
    assert ("p_baseline_2" in tledger) == (not fail)
    assert "p_baseline_1" in tledger and "p_testinspect_0" in tledger
    assert tout == jout == ["p_baseline_1", "p_baseline_2",
                            "p_testinspect_0"]   # _0 resumed from the ledger
    assert [(_jax_module(c), kw) for c, kw in tcalls] == jcalls
    assert tprog == jprog                          # progress messages


def test_run_pool_progress_bytes_match_jax(monkeypatch):
    class Clock:
        def __init__(self):
            self.t = 1000.0

        def time(self):
            self.t += 47.0
            return self.t

    outs = []
    for mod in (jpool, tpool):
        monkeypatch.setattr(mod, "time", Clock())
        out = io.StringIO()
        res = list(mod.run_pool(_double, range(9), pool_factory=mod.SerialPool,
                                out=out, seed=3))
        outs.append((res, out.getvalue()))
    assert outs[0] == outs[1]
    assert sorted(outs[1][0]) == [2 * a for a in range(9)]
    assert "9/0 " in outs[1][1] and outs[1][1].startswith("0/9 0/?\r")
    # unshuffled, the order of the arguments
    out = io.StringIO()
    assert list(tpool.run_pool(_double, [3, 1], pool_factory=tpool.SerialPool,
                               out=out, shuffle=False)) == [6, 2]


def _double(a):
    return f"done {a}", 2 * a


def test_pool_workers_are_picklable():
    w1 = functools.partial(TR.launch_container, exec_fn=sp.run)
    w2 = functools.partial(TR._provision_worker, exec_fn=sp.run)
    assert pickle.loads(pickle.dumps(w1)).func is TR.launch_container
    assert pickle.loads(pickle.dumps(w2)).func is TR._provision_worker


@pytest.mark.parametrize("case", ["vendored", "work_dir_pins", "unpinned"])
def test_provision_subject_matches_jax(tmp_path, monkeypatch, case):
    line = {"vendored": "Delgan/loguru,abc123,.,python -m pytest tests",
            "work_dir_pins": "o/p,abc,src,pytest",
            "unpinned": "o/p,abc,.,python -m pytest"}[case]
    transcripts = []
    for R, S in ((JR, jsubjects), (TR, tsubjects)):
        monkeypatch.setattr(R, "SUBJECTS_DIR", str(tmp_path))
        s = S.parse_subject_line(line)
        pins = tmp_path / s.name / "requirements.txt"
        if case == "work_dir_pins":
            pins.parent.mkdir(exist_ok=True)
            pins.write_text("only-this==1.0\n")
        rec = Recorder()
        R.provision_subject(s, exec_fn=rec)
        transcripts.append((rec.calls, pins.read_text()
                            if pins.exists() else None))
        if pins.exists():
            pins.unlink()
    assert transcripts[1] == transcripts[0]
    calls, seeded = transcripts[1]
    joined = [" ".join(c) for c, _ in calls]
    if case == "vendored":
        assert "psutil==5.8.0" in seeded
        assert not any(j.endswith("psutil") for j in joined)
    elif case == "work_dir_pins":
        assert seeded == "only-this==1.0\n"
        assert any(" psutil -e " in j for j in joined)
    else:
        assert seeded is None and not any("-r" in c for c, _ in calls)


def test_provision_all_matches_jax(tmp_path, monkeypatch):
    reg = tmp_path / "subjects.txt"
    reg.write_text("o/a,1,.,pytest\no/b,2,src,pytest\n")
    runs = []
    for R, pool in ((JR, jpool), (TR, tpool)):
        monkeypatch.setattr(R, "SUBJECTS_DIR", str(tmp_path / "work"))
        monkeypatch.setattr(R, "CONT_DATA_DIR", str(tmp_path / "contdata"))
        rec, out = Recorder(), io.StringIO()
        R.provision_all(str(reg), exec_fn=rec, pool_kwargs={
            "pool_factory": pool.SerialPool, "out": out, "seed": 1})
        runs.append((rec.calls, out.getvalue()))
    assert runs[1] == runs[0]
    assert "provisioned: a" in runs[1][1] and "provisioned: b" in runs[1][1]
    assert (tmp_path / "contdata").is_dir()


def test_packaged_registry_and_vendored_pins(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    subjects = list(tsubjects.iter_subjects())
    assert subjects == [tsubjects.Subject(**vars(s))
                        for s in jsubjects.iter_subjects()]
    assert len(subjects) == 26
    assert [s.name for s in subjects
            if not TR.vendored_requirements(s.name)] == []
    assert all(TR.vendored_requirements(s.name)
               == JR.vendored_requirements(s.name) for s in subjects)
    assert TR.vendored_requirements("no-such-subject") is None
    # a registry in the working directory overrides the packaged one
    (tmp_path / "subjects.txt").write_text("# c\no/p,abc,.,python -m pytest\n")
    assert [s.name for s in tsubjects.iter_subjects()] == ["p"]


def test_cli_host_verbs_dispatch(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(TR, "provision_all", lambda: calls.append("setup"))
    monkeypatch.setattr(TR, "container_entrypoint",
                        lambda *a: calls.append(("container", a)))
    monkeypatch.setattr(TR, "run_experiment",
                        lambda modes: calls.append(("run", modes)))
    # no telemetry run: the verbs return before obs.configure_from_env
    root = tmp_path / "telemetry"
    monkeypatch.setenv("F16_TELEMETRY", str(root))
    tmain.main(["setup"])
    tmain.main(["container", "p_baseline_0", "a b", "pytest -q"])
    tmain.main(["run", "baseline", "shuffle"])
    assert calls == ["setup", ("container", ("p_baseline_0", "a b",
                                             "pytest -q")),
                     ("run", ["baseline", "shuffle"])]
    assert not root.exists()
    with pytest.raises(ValueError, match="Unrecognized setup option"):
        tmain.main(["setup", "now"])
    with pytest.raises(ValueError, match="Unrecognized tests option"):
        tmain.main(["tests", "data"])
