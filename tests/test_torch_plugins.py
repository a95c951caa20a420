"""The port's pytest plugins (``plugins/``) against the JAX package's, on
the toy suites of tests/test_plugins.py run in pytest subprocesses: the
showflakes record files byte for byte under the same ``SHOWFLAKES_SEED``,
``--set-exitstatus``, and testinspect's coverage, pickle and TSV order
from a second, separate run (the rusage values are measured, so only
their count and finiteness are compared); ``git_churn`` and the static
features on fixtures. Then the collection loop and the chain on the CPU:
the port's plugins on toy git subjects, the port's ``write_tests``
(byte-equal to the JAX package's on the same artifacts), and on the
28-test chain subject the port's ``write_scores`` (counts equal to the
JAX package's) and ``write_figures``.

Each run loads one package's plugins: the two sets register the same
options and names and cannot share a pytest process."""

import io
import math
import os
import pickle
import sqlite3
import sys
import textwrap

import jax
import numpy as np
import pytest

from flake16_framework_tpu.plugins import churn as jchurn
from flake16_framework_tpu.plugins import static_features as jstatic
from flake16_framework_tpu.plugins import testinspect as jinspect
from flake16_framework_tpu.runner import collate as JC
from flake16_framework_tpu_torch.constants import FLAKY, NON_FLAKY, OD_FLAKY
from flake16_framework_tpu_torch.plugins import churn as tchurn
from flake16_framework_tpu_torch.plugins import static_features as tstatic
from flake16_framework_tpu_torch.plugins import testinspect as tinspect
from flake16_framework_tpu_torch.runner import collate as TC
from flake16_framework_tpu_torch.runner.containers import PLUGIN_SELECT
from torch_collect_cases import (
    chain_shuffle_seeds, collect, git_commit_all, make_chain_subject,
)

pytest_plugins = ["pytester"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLUGIN = {"jax": "flake16_framework_tpu.plugins.",
          "torch": "flake16_framework_tpu_torch.plugins."}


def _run(pytester, *args):
    # runpytest_subprocess inherits os.environ; splice the repo onto
    # PYTHONPATH for the child and restore afterwards.
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = REPO + (os.pathsep + old if old else "")
    try:
        return pytester.runpytest_subprocess(*args)
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old


@pytest.fixture
def toy_suite(pytester):
    pytester.makepyfile(
        src=textwrap.dedent("""
            def double(v):
                return 2 * v

            def triple(v):
                return 3 * v
        """),
        test_toy=textwrap.dedent("""
            import src

            def test_double():
                assert src.double(2) == 4

            def test_triple():
                assert src.triple(2) == 6

            def test_fails():
                assert src.double(1) == 3

            def test_skipped():
                import pytest
                pytest.skip("nope")

            def test_more():
                assert [src.double(v) for v in range(3)] == [0, 2, 4]
        """),
    )
    return pytester


@pytest.mark.parametrize("flags", [
    ("--set-exitstatus",),
    ("--shuffle", "--set-exitstatus"),
    (),
    ("--shuffle",),
])
def test_showflakes_record_file_matches_jax(toy_suite, monkeypatch, flags):
    monkeypatch.setenv("SHOWFLAKES_SEED", "3")
    out = {}
    for pkg in ("jax", "torch"):
        res = _run(toy_suite, "-p", PLUGIN[pkg] + "showflakes",
                   f"--record-file={pkg}.tsv", *flags)
        out[pkg] = (res.ret, (toy_suite.path / f"{pkg}.tsv").read_bytes())
    assert out["torch"] == out["jax"]
    ret, body = out["torch"]
    # failures are data under --set-exitstatus, an error exit otherwise
    assert ret == (0 if "--set-exitstatus" in flags
                   else pytest.ExitCode.TESTS_FAILED)
    rows = dict(line.split("\t")[::-1]
                for line in body.decode().splitlines())
    assert len(rows) == 5
    assert rows["test_toy.py::test_fails"] == "failed"
    assert rows["test_toy.py::test_skipped"] == "skipped"
    assert rows["test_toy.py::test_double"] == "passed"


def _coverage(path):
    """{(nodeid, file): lines} from a testinspect sqlite file."""
    con = sqlite3.connect(path)
    contexts = dict(con.execute("SELECT id, context FROM context"))
    files = dict(con.execute("SELECT id, path FROM file"))
    cov = {(contexts[c], files[f]): TC.numbits_to_lines(blob)
           for c, f, blob in con.execute(
               "SELECT context_id, file_id, numbits FROM line_bits")}
    con.close()
    return cov


def test_testinspect_artifacts_match_jax(toy_suite):
    art = {}
    for pkg in ("jax", "torch"):
        res = _run(toy_suite, "-p", PLUGIN[pkg] + "testinspect",
                   f"--testinspect={pkg}")
        assert res.ret == pytest.ExitCode.TESTS_FAILED
        with open(toy_suite.path / f"{pkg}.pkl", "rb") as fd:
            static = pickle.load(fd)
        rows = []
        for line in (toy_suite.path / f"{pkg}.tsv").read_text().splitlines():
            *vals, nid = line.split("\t", 6)
            rows.append((nid, [float(v) for v in vals]))
        art[pkg] = (_coverage(toy_suite.path / f"{pkg}.sqlite3"), static,
                    rows)
    (jcov, jstat, jrows), (tcov, tstat, trows) = art["jax"], art["torch"]
    assert tcov == jcov
    src = str(toy_suite.path / "src.py")
    assert {nid for nid, f in tcov if f == src} >= {
        "test_toy.py::test_double", "test_toy.py::test_triple"}
    assert tstat == jstat                # (fn_ids, fn_data, files, churn)
    fn_ids, fn_data, test_files, churn = tstat
    assert sorted(fn_ids.values()) == list(range(1, 6))   # ids from 1
    assert test_files == {"test_toy.py"} and churn == {}  # not a git repo
    assert [nid for nid, _ in trows] == [nid for nid, _ in jrows]
    assert len(trows) == 5
    for _, vals in trows:
        assert len(vals) == 6 and all(math.isfinite(v) for v in vals)
        assert vals[0] > 0 and vals[5] > 0      # execution time, max RSS


def test_testinspect_excludes_its_own_directory():
    tracer = tinspect._LineTracer("/")
    assert tracer._own == os.path.join(REPO, "flake16_framework_tpu_torch",
                                       "plugins") + os.sep
    assert tracer._own != jinspect._LineTracer("/")._own


def test_numbits_encode_matches_jax():
    rs = np.random.RandomState(0)
    cases = [set(), {0}, {1, 7, 8, 9, 200}, set(range(0, 977, 13)),
             set(rs.randint(0, 5000, size=300).tolist())]
    for lines in cases:
        blob = tinspect.lines_to_numbits(lines)
        assert blob == jinspect.lines_to_numbits(lines)
        assert TC.numbits_to_lines(blob) == lines


def test_git_churn_matches_jax(tmp_path):
    def commit(msg):
        git_commit_all(str(tmp_path), msg)

    f = tmp_path / "a.py"
    f.write_text("one\ntwo\nthree\n")
    commit("c1")
    f.write_text("one\nTWO!\nthree\n")          # modify line 2
    commit("c2")
    f.write_text("zero\none\nTWO!\nthree\n")    # insert line 1
    commit("c3")
    g = tmp_path / "café dir" / "naïve.py"       # C-quoted by git log
    g.parent.mkdir()
    g.write_text("x\ny\n")
    (tmp_path / "gone.py").write_text("1\n")
    commit("c4")
    (tmp_path / "gone.py").unlink()             # deleted
    g.write_text("y\n")                          # line 1 removed
    commit("c5")

    got = tchurn.git_churn(str(tmp_path))
    assert got == jchurn.git_churn(str(tmp_path))
    assert got["a.py"] == {1: 1, 2: 1, 3: 2, 4: 1}
    assert got["café dir/naïve.py"] == {1: 1}
    assert "gone.py" not in got
    assert tchurn.git_churn("/") is None is jchurn.git_churn("/")


def test_static_features_match_jax(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(textwrap.dedent("""
        import os
        import json
        from . import sibling

        def test_branchy():
            vals = [v for v in range(10) if v % 2]
            if os.sep and vals:
                assert json.dumps(vals)
            assert len(vals) == 5

        async def test_async(x):
            try:
                y = x if x else -x
            except ValueError:
                self.fail("no")
            return y

        def test_empty():
            pass
    """))
    ta, ja = tstatic.ModuleAnalyzer(), jstatic.ModuleAnalyzer()
    for name, line in (("test_branchy", 6), ("test_async", 12),
                       ("test_empty", 19), ("test_missing", 1)):
        assert ta.features_for(str(p), name, line) == ja.features_for(
            str(p), name, line)
    depth, asserts, ext, volume, cc, loc, mi = ta.features_for(
        str(p), "test_branchy", 6)
    assert asserts == 2.0 and ext == 2.0 and cc >= 4.0
    # every function of a real module
    path = os.path.join(REPO, "tests", "test_plugins.py")
    import ast
    with open(path) as fd:
        fns = [n for n in ast.walk(ast.parse(fd.read()))
               if isinstance(n, ast.FunctionDef)]
    assert len(fns) > 10
    for fn in fns:
        assert ta.features_for(path, fn.name, fn.lineno) == ja.features_for(
            path, fn.name, fn.lineno)


def _toy_loop_subject(checkout):
    """The 4-test subject of tests/test_plugins.py's collection loop."""
    os.makedirs(checkout)
    with open(os.path.join(checkout, "pytest.ini"), "w") as fd:
        fd.write("[pytest]\n")
    # seeds the global random module: the shuffle's private RNG is immune
    with open(os.path.join(checkout, "conftest.py"), "w") as fd:
        fd.write("import random\nrandom.seed(0)\n")
    with open(os.path.join(checkout, "test_toy.py"), "w") as fd:
        fd.write(textwrap.dedent("""
            import os

            RAN_A = False

            def test_a():
                global RAN_A
                RAN_A = True

            def test_b():
                assert RAN_A

            def test_nod():
                assert int(os.environ["TOY_RUN"]) % 2 == 0

            def test_stable():
                assert True
        """))
    git_commit_all(checkout)


def test_full_collection_loop_matches_jax(tmp_path):
    """The port's plugins, selected as the port's container command selects
    them, across 4 baseline, 4 shuffle and 1 testinspect run; the port's
    ``write_tests`` labels NON_FLAKY, OD and NOD as the JAX loop does, and
    the JAX ``write_tests`` gives the same bytes on the same artifacts."""
    subjects = tmp_path / "subjects"
    checkout = subjects / "proj" / "proj"
    data = tmp_path / "data"
    data.mkdir()
    _toy_loop_subject(str(checkout))
    # seeds 0, 1: test_a before test_b; 2, 6: test_b first (fails)
    collect(str(checkout), str(data), "proj", PLUGIN_SELECT, REPO,
            shuffle_seeds=[0, 1, 2, 6])
    n_runs = {"baseline": 4, "shuffle": 4, "testinspect": 1}
    tests = TC.write_tests(str(data), str(tmp_path / "t.json"),
                           str(subjects), n_runs)
    JC.write_tests(str(data), str(tmp_path / "j.json"), str(subjects),
                   n_runs)
    assert (tmp_path / "t.json").read_bytes() == (
        tmp_path / "j.json").read_bytes()
    labels = {nid.split("::")[-1]: row[1] for nid, row in
              tests["proj"].items()}
    assert labels == {"test_a": NON_FLAKY, "test_b": OD_FLAKY,
                      "test_nod": FLAKY, "test_stable": NON_FLAKY}
    for row in tests["proj"].values():
        assert len(row) == 2 + 16
        assert row[2] > 0 and row[3] > 0 and row[5] > 0


@pytest.fixture
def _jax_x64_off():
    with jax.enable_x64(False):
        yield


@pytest.mark.usefixtures("_jax_x64_off")
def test_chain_plugins_to_scores_to_figures(tmp_path, monkeypatch):
    """The chain on the CPU: the port's plugins on the 28-test subject
    (14 stable, 12 NOD, one OD pair), its ``write_tests``, its
    ``write_scores`` on one NOD Random Forest and one NOD Decision Tree
    config (counts equal to the JAX package's on the same ``tests.json``),
    its ``write_shap`` and ``write_figures`` on the result."""
    from flake16_framework_tpu import pipeline as jpipe
    from flake16_framework_tpu_torch import config as tcfg
    from flake16_framework_tpu_torch import pipeline as tpipe
    from flake16_framework_tpu_torch.figures.report import write_figures
    from flake16_framework_tpu_torch.runner.subjects import Subject

    monkeypatch.setitem(sys.modules, "requests", None)
    subjects = tmp_path / "subjects"
    checkout = subjects / "proj" / "proj"
    data = tmp_path / "data"
    data.mkdir()
    make_chain_subject(str(checkout))
    collect(str(checkout), str(data), "proj", PLUGIN_SELECT, REPO,
            shuffle_seeds=chain_shuffle_seeds())
    monkeypatch.chdir(tmp_path)
    tests = TC.write_tests(str(data), "tests.json", str(subjects),
                           {"baseline": 4, "shuffle": 2, "testinspect": 1})
    labels = {nid.split("::")[-1]: row[1] for nid, row in
              tests["proj"].items()}
    assert len(labels) == 28
    assert all(labels[f"test_nod_{i:02d}"] == FLAKY for i in range(12))
    assert all(labels[f"test_stable_{i:02d}"] == NON_FLAKY
               for i in range(14))
    assert labels["test_aa_dep"] == NON_FLAKY
    assert labels["test_zz_od"] == OD_FLAKY

    configs = [("NOD", "Flake16", "None", "None", "Random Forest"),
               ("NOD", "Flake16", "None", "None", "Decision Tree")]
    kw = dict(max_depth=12, configs=configs, progress_out=io.StringIO(),
              tree_overrides={"Random Forest": 4})
    got = tpipe.write_scores("tests.json", "scores-t.pkl", device="cpu", **kw)
    want = jpipe.write_scores("tests.json", "scores-j.pkl", journal=False,
                              **kw)
    for k in configs:
        assert got[k][2:] == want[k][2:], k
        fp, fn, tp = got[k][3][:3]
        assert fp + fn + tp <= 28 and tp > 0
        assert set(got[k][2]) == {"proj"}

    shap = tpipe.write_shap("tests.json", "shap.pkl", max_depth=12,
                            tree_overrides={"Random Forest": 4,
                                            "Extra Trees": 4}, device="cpu")
    assert all(np.isfinite(s["values"]).all() and s["values"].shape
               == (28, 16) for s in shap)
    padded = {k: got.get(k, got[configs[0]]) for k in tcfg.iter_config_keys()}
    with open("scores.pkl", "wb") as fd:
        pickle.dump(padded, fd)
    write_figures(subjects=[Subject(name="proj", repo="org/proj", sha="x",
                                    package_dir=".", commands=("pytest",))],
                  star_fetch=lambda repo: {})
    for name in ("tests.tex", "req-runs.tex", "corr.tex", "nod-top.tex",
                 "shap.tex"):
        assert os.path.getsize(name) > 0, name
