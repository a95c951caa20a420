"""The port's collation (``runner/collate.py``) against the JAX package's:
the numbits decode, the OD/NOD state machine, the coverage features, the
ingestors and the falsy completeness rules on the cases of
tests/test_collate.py, and ``write_tests`` byte for byte on seeded data
directories in the plugins' formats (tests/torch_collect_cases.py), whose
expected ``tests.json`` is built without the collation code. The JAX
package may decode through its C++ fast path or its Python path; the
bytes must agree either way."""

import json
import os
import pickle
import sqlite3
import subprocess
import sys

import numpy as np
import pytest

from flake16_framework_tpu.runner import collate as JC
from flake16_framework_tpu_torch.constants import FLAKY, NON_FLAKY, OD_FLAKY
from flake16_framework_tpu_torch.runner import collate as TC
from flake16_framework_tpu_torch.utils.synth import make_dataset
from torch_collect_cases import write_data_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = {"baseline": 4, "shuffle": 4, "testinspect": 1}
SMALL_RUNS = {"baseline": 8, "shuffle": 8, "testinspect": 1}


@pytest.mark.parametrize("seed", range(4))
def test_numbits_decode_matches_jax(seed):
    rs = np.random.RandomState(seed)
    for size in (0, 1, 7, 64, 1000):
        blob = bytes(rs.randint(0, 256, size=size, dtype=np.uint8))
        got = TC.numbits_to_lines(blob)
        assert got == JC.numbits_to_lines(blob)
        assert got == JC._numbits_to_lines_py(blob)
    assert TC.numbits_to_lines(bytes([0b00000101])) == {0, 2}
    assert TC.numbits_to_lines(bytes([0, 0b10000000])) == {15}


def test_ingest_runs_tracks_min_runs():
    got = []
    for C in (JC, TC):
        proj = C.ProjectData()
        C.ingest_runs_tsv(["passed\tt1", "failed\tt2"], "baseline", 3, proj)
        C.ingest_runs_tsv(["failed\tt1", "failed\tt2\n"], "baseline", 1, proj)
        C.ingest_runs_tsv(["passed\tt1", "skipped\tt2"], "shuffle", 0, proj)
        got.append({nid: {m: vars(s) for m, s in rec.runs.items()}
                    for nid, rec in proj.tests.items()})
    assert got[1] == got[0]
    assert got[1]["t1"]["baseline"] == {"n_runs": 2, "n_fail": 1,
                                        "min_fail_run": 1, "min_pass_run": 3}
    assert got[1]["t2"]["shuffle"]["n_fail"] == 0


def _stats(C, n_runs, n_fail, min_fail, min_pass):
    s = C.RunStats()
    s.n_runs, s.n_fail = n_runs, n_fail
    s.min_fail_run, s.min_pass_run = min_fail, min_pass
    return s


@pytest.mark.parametrize("base,shuf,expected", [
    ((3, 0, None, 0), (4, 0, None, 0), (0, None)),
    ((4, 0, None, 0), (3, 0, None, 0), (0, None)),
    ((4, 0, None, 0), (4, 0, None, 0), (0, NON_FLAKY)),
    ((4, 0, None, 0), (4, 1, 2, 0), (2, OD_FLAKY)),
    ((4, 4, 0, None), (4, 4, 0, None), (0, NON_FLAKY)),
    ((4, 4, 0, None), (4, 3, 0, 3), (3, OD_FLAKY)),
    ((4, 1, 2, 0), (4, 0, None, 0), (2, FLAKY)),
    ((4, 3, 0, 1), (4, 4, 0, None), (1, FLAKY)),
])
def test_labeling_state_machine_matches_jax(base, shuf, expected):
    got = TC.label_test({"baseline": _stats(TC, *base),
                         "shuffle": _stats(TC, *shuf)}, N)
    want = JC.label_test({"baseline": _stats(JC, *base),
                          "shuffle": _stats(JC, *shuf)}, N)
    assert got == want == expected
    # a mode with no runs at all is incomplete
    assert TC.label_test({"baseline": _stats(TC, *base)}, N) == (0, None)


@pytest.mark.parametrize("cov,test_files,churn,expected", [
    ({"a.py": {1, 2, 3}, "b.py": {1, 2, 3}}, {"a.py"},
     {"a.py": {1: 1}, "b.py": {1: 1, 2: 2}}, (6, 4, 3)),
    ({"a.py": {1, 2, 3}, "b.py": {1, 2, 3}}, set(),
     {"a.py": {1: 1}, "b.py": {1: 1, 2: 2}}, (6, 4, 6)),
    ({"a.py": {1}}, set(), {}, (1, 0, 1)),
    ({}, {"t.py"}, {"t.py": {1: 5}}, (0, 0, 0)),
])
def test_coverage_features_match_jax(cov, test_files, churn, expected):
    got = TC.coverage_features(cov, test_files, churn)
    assert got == JC.coverage_features(cov, test_files, churn) == expected
    assert got == JC._coverage_features_py(cov, test_files, churn)


def test_coverage_db_ingest_matches_jax(tmp_path):
    db = tmp_path / "p_testinspect_0.sqlite3"
    con = sqlite3.connect(db)
    con.executescript("""
        CREATE TABLE context (id INTEGER PRIMARY KEY, context TEXT);
        CREATE TABLE file (id INTEGER PRIMARY KEY, path TEXT);
        CREATE TABLE line_bits (context_id INT, file_id INT, numbits BLOB);
    """)
    con.execute("INSERT INTO context VALUES (1, 't1'), (2, 't2')")
    root = os.path.join(TC.SUBJECTS_DIR, "p", "p")
    con.execute("INSERT INTO file VALUES (1, ?), (2, ?)",
                (os.path.join(root, "src.py"),
                 os.path.join(root, "tests", "test_src.py")))
    con.execute("INSERT INTO line_bits VALUES (1, 1, ?)", (bytes([0b110]),))
    con.execute("INSERT INTO line_bits VALUES (2, 2, ?)", (bytes([0b1000]),))
    con.commit()
    got = []
    for C in (JC, TC):
        proj = C.ProjectData()
        C.ingest_coverage_db(con, "p", proj)
        got.append({nid: rec.coverage for nid, rec in proj.tests.items()})
    con.close()
    assert got[1] == got[0] == {
        "t1": {"src.py": {1, 2}},
        "t2": {os.path.join("tests", "test_src.py"): {3}}}


def test_falsy_completeness_matches_jax():
    """The reference's ``all(...)`` semantics: fn_id 0, or an empty
    test_files set or churn dict, drop the test or the project."""
    for C in (JC, TC):
        rec = C.TestRecord()
        assert not rec.complete()
        rec.runs["baseline"] = _stats(C, 4, 0, None, 0)
        rec.coverage["a.py"] = {1}
        rec.rusage = [1.0] * 6
        rec.fn_id = 0
        assert not rec.complete()
        rec.fn_id = 1
        assert rec.complete()
        rec.rusage = []
        assert not rec.complete()
        rec.rusage = [1.0] * 6

        proj = C.ProjectData()
        assert not proj.complete()
        proj.tests["t"] = rec
        proj.fn_features = {1: (1,) * 7}
        proj.test_files = set()
        proj.churn = {"a.py": {1: 1}}
        assert not proj.complete()
        proj.test_files = {"tests/x.py"}
        assert proj.complete()
        proj.churn = {}
        assert not proj.complete()
        proj.churn = {"a.py": {1: 1}}
        proj.fn_features = {}
        assert not proj.complete()


def _small_dataset(seed):
    return make_dataset(n_tests=60, n_projects=3, seed=seed, nod_frac=0.2,
                        od_frac=0.2)


@pytest.mark.parametrize("seed", [0, 1])
def test_write_tests_bytes_equal_jax_on_seeded_data(tmp_path, seed):
    """3 projects, about 60 tests and the cases the collation drops, at
    8 + 8 + 1 runs: the port's ``tests.json`` is the JAX package's byte
    for byte, and its parse is the generator's expected dict."""
    data = str(tmp_path / "data")
    subjects = str(tmp_path / "subjects")
    expected, stats = write_data_dir(data, _small_dataset(seed), SMALL_RUNS,
                                     subjects, seed=seed)
    assert stats["files"] == 3 * (8 + 8 + 3)
    got = TC.write_tests(data, str(tmp_path / "t.json"), subjects, SMALL_RUNS)
    want = JC.write_tests(data, str(tmp_path / "j.json"), subjects,
                          SMALL_RUNS)
    with open(tmp_path / "t.json", "rb") as a, \
            open(tmp_path / "j.json", "rb") as b:
        assert a.read() == b.read()
    assert got == want
    with open(tmp_path / "t.json") as fd:
        assert json.load(fd) == expected
    labels = [row[1] for rows in expected.values() for row in rows.values()]
    assert {NON_FLAKY, OD_FLAKY, FLAKY} <= set(labels)
    assert sum(len(rows) for rows in expected.values()) == 60
    assert sorted(os.listdir(tmp_path)) == ["data", "j.json", "t.json"]


def test_write_tests_bytes_equal_jax_on_the_reference_shapes(tmp_path):
    """The fake data directory of tests/test_collate.py (one project, two
    complete tests) through both packages."""
    data = tmp_path / "data"
    data.mkdir()
    for mode in ("baseline", "shuffle"):
        for run_n in range(N[mode]):
            fail = mode == "shuffle" and run_n == 1
            (data / f"proj_{mode}_{run_n}.tsv").write_text(
                f"{'failed' if fail else 'passed'}\tt1\npassed\tt2\n")
    con = sqlite3.connect(data / "proj_testinspect_0.sqlite3")
    con.executescript("""
        CREATE TABLE context (id INTEGER PRIMARY KEY, context TEXT);
        CREATE TABLE file (id INTEGER PRIMARY KEY, path TEXT);
        CREATE TABLE line_bits (context_id INT, file_id INT, numbits BLOB);
    """)
    root = os.path.join(str(tmp_path), "proj", "proj")
    con.execute("INSERT INTO context VALUES (1, 't1'), (2, 't2')")
    con.execute("INSERT INTO file VALUES (1, ?)",
                (os.path.join(root, "m.py"),))
    con.execute("INSERT INTO line_bits VALUES (1, 1, ?)", (bytes([0b11]),))
    con.execute("INSERT INTO line_bits VALUES (2, 1, ?)", (bytes([0b01]),))
    con.commit()
    con.close()
    (data / "proj_testinspect_0.tsv").write_text(
        "1.0\t2\t3\t4\t5\t6\tt1\n0.5\t1\t1\t1\t1\t1\tt2\n")
    with open(data / "proj_testinspect_0.pkl", "wb") as fd:
        pickle.dump(({"t1": 1, "t2": 2},
                     {1: (3, 1, 0, 9.9, 2, 12, 80.0),
                      2: (2, 0, 1, 5.5, 1, 8, 90.0)},
                     {"tests/test_m.py"}, {"m.py": {0: 2}}), fd)
    tests = TC.write_tests(str(data), str(tmp_path / "t.json"),
                           str(tmp_path), N)
    JC.write_tests(str(data), str(tmp_path / "j.json"), str(tmp_path), N)
    assert (tmp_path / "t.json").read_bytes() == (
        tmp_path / "j.json").read_bytes()
    assert list(tests["proj"]) == ["t1", "t2"]
    t1 = tests["proj"]["t1"]
    assert t1[:5] == (1, OD_FLAKY, 2, 2, 2)
    assert t1[5:11] == (1.0, 2, 3, 4, 5, 6)
    assert t1[11:] == (3, 1, 0, 9.9, 2, 12, 80.0)
    assert tests["proj"]["t2"][1] == NON_FLAKY


_TORCH_FREE = r'''
import sys, threading
sys.modules["torch"] = None
sys.modules["numpy"] = None
import flake16_framework_tpu_torch.runner.pool
import flake16_framework_tpu_torch.runner.containers
import flake16_framework_tpu_torch.runner.collate
import flake16_framework_tpu_torch.plugins.churn
import flake16_framework_tpu_torch.plugins.static_features
import flake16_framework_tpu_torch.plugins.showflakes
import flake16_framework_tpu_torch.plugins.testinspect
assert threading.active_count() == 1, threading.enumerate()
import runpy
sys.argv = ["flake16_framework_tpu_torch", "tests"]
runpy.run_module("flake16_framework_tpu_torch", run_name="__main__",
                 alter_sys=True)
assert sys.modules["torch"] is None and sys.modules["numpy"] is None
print("torch-free ok")
'''


def test_host_path_needs_no_torch(tmp_path):
    """With torch and numpy blocked, the runner and plugin modules import,
    start no thread, and ``python -m flake16_framework_tpu_torch tests``
    collates a ``data/`` directory at the full run counts."""
    from flake16_framework_tpu_torch.constants import N_RUNS, SUBJECTS_DIR

    ds = make_dataset(n_tests=10, n_projects=2, seed=5, nod_frac=0.3,
                      od_frac=0.3)
    expected, _ = write_data_dir(str(tmp_path / "data"), ds, N_RUNS,
                                 SUBJECTS_DIR, seed=5)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("F16_TELEMETRY", None)
    out = subprocess.run([sys.executable, "-c", _TORCH_FREE], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("torch-free ok")
    with open(tmp_path / "tests.json") as fd:
        assert json.load(fd) == expected
