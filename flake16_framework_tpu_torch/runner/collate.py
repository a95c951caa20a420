"""Collation, labelling and feature assembly (a copy of the Python paths
of the JAX package's ``runner/collate.py``): fold the ``data/`` directory
of raw plugin outputs into per-test records, label each test with the
OD/NOD state machine, assemble the 16 Flake16 features and write
``tests.json`` (``{proj: {nodeid: [req_runs, label, *16 features]}}``).

The inputs, the output and every rule are the JAX package's:

- runs TSVs (showflakes): ``outcome\\tnodeid`` lines; an outcome holding
  "failed" is a failure; the least failing and least passing run number
  is kept per mode.
- coverage sqlite (testinspect, coverage.py 5.x schema): ``context``/
  ``file``/``line_bits`` tables, line sets numbits-encoded.
- rusage TSV: 6 floats + nodeid.
- static pickle: (test_fn_ids, test_fn_data, test_files, churn).
- labelling: incomplete -> excluded; baseline never fails and shuffle
  fails -> OD; baseline always fails and shuffle not always -> OD;
  baseline intermittent -> NOD; else NON_FLAKY (0/1/2, ``constants``).
- completeness keeps the reference's *falsy* semantics: a test with
  fn_id 0 and a project with an empty test_files set or churn dict are
  dropped, as the reference's ``all(...)`` checks drop them.

The numbits decode and the coverage feature sums, the collation's hot
loops, run in C++ (``native/collate_fast.cc``, built at first use by
``native.load``). Where the JAX package falls back to its Python bodies
when that build fails, this package raises (``native.NativeBuildError``).
The Python bodies stay beside them as the plain versions
(``_numbits_to_lines_py``, ``_coverage_features_py``) that the tests hold
the native module against.
"""

import json
import os
import pickle
import sqlite3
from dataclasses import dataclass, field

from flake16_framework_tpu_torch import native
from flake16_framework_tpu_torch.constants import (
    DATA_DIR, FLAKY, N_RUNS, NON_FLAKY, OD_FLAKY, SUBJECTS_DIR, TESTS_FILE,
)
from flake16_framework_tpu_torch.utils.atomic import atomic_write


def _numbits_to_lines_py(blob):
    out = set()
    for byte_i, byte in enumerate(blob):
        while byte:
            low = byte & -byte
            out.add(byte_i * 8 + low.bit_length() - 1)
            byte &= byte - 1
    return out


def numbits_to_lines(blob):
    """Decode a coverage.py numbits blob: bit k of byte n set => line
    8n+k covered. Runs in the native module."""
    return native.load().numbits_to_lines(blob)


@dataclass
class RunStats:
    """Per-(test, mode) rerun tally."""
    n_runs: int = 0
    n_fail: int = 0
    min_fail_run: int | None = None
    min_pass_run: int | None = None

    def record(self, failed, run_n):
        self.n_runs += 1
        if failed:
            self.n_fail += 1
            self.min_fail_run = (
                run_n if self.min_fail_run is None
                else min(self.min_fail_run, run_n)
            )
        else:
            self.min_pass_run = (
                run_n if self.min_pass_run is None
                else min(self.min_pass_run, run_n)
            )


@dataclass
class TestRecord:
    runs: dict = field(default_factory=dict)     # mode -> RunStats
    coverage: dict = field(default_factory=dict) # file -> set(lines)
    rusage: list | None = None                   # 6 floats
    fn_id: int | None = None

    def complete(self):
        # Falsy semantics of the reference's `all(...)` filter: fn_id 0
        # counts as incomplete.
        return bool(self.runs) and bool(self.coverage) and (
            bool(self.rusage) and bool(self.fn_id)
        )


@dataclass
class ProjectData:
    tests: dict = field(default_factory=dict)  # nodeid -> TestRecord
    fn_features: dict | None = None            # fn_id -> 7 static features
    test_files: set | None = None
    churn: dict | None = None                  # file -> {line: change_count}

    def test(self, nid):
        return self.tests.setdefault(nid, TestRecord())

    def complete(self):
        # Falsy semantics: empty fn_features/test_files/churn drop the
        # whole project, as in the reference.
        return bool(self.tests) and bool(self.fn_features) and (
            bool(self.test_files) and bool(self.churn)
        )


def ingest_runs_tsv(lines, mode, run_n, project):
    """showflakes output: one ``outcome\\tnodeid`` line per executed test."""
    for line in lines:
        outcome, nid = line.rstrip("\n").split("\t", 1)
        project.test(nid).runs.setdefault(mode, RunStats()).record(
            "failed" in outcome, run_n
        )


def ingest_coverage_db(con, proj_name, project, subjects_dir=SUBJECTS_DIR):
    """testinspect coverage DB: dynamic-context line coverage per test."""
    proj_root = os.path.join(subjects_dir, proj_name, proj_name)
    cur = con.cursor()

    contexts = dict(cur.execute("SELECT id, context FROM context"))
    files = {
        fid: os.path.relpath(path, start=proj_root)
        for fid, path in cur.execute("SELECT id, path FROM file")
    }

    for ctx_id, file_id, blob in cur.execute(
        "SELECT context_id, file_id, numbits FROM line_bits"
    ):
        rec = project.test(contexts[ctx_id])
        rec.coverage[files[file_id]] = numbits_to_lines(blob)


def ingest_rusage_tsv(lines, project):
    for line in lines:
        *vals, nid = line.rstrip("\n").split("\t", 6)
        project.test(nid).rusage = [float(v) for v in vals]


def ingest_static_pickle(fd, project):
    test_fn_ids, fn_features, test_files, churn = pickle.load(fd)
    project.fn_features = fn_features
    project.test_files = test_files
    project.churn = churn
    for nid, fid in test_fn_ids.items():
        project.test(nid).fn_id = fid


def scan_data_dir(data_dir=DATA_DIR):
    """Yield (path, proj, mode, run_n, ext) for every raw artifact (name
    contract {proj}_{mode}_{run_n}.{ext})."""
    for file_name in os.listdir(data_dir):
        proj, mode, rest = file_name.split("_", 2)
        run_n, ext = rest.split(".", 1)
        yield os.path.join(data_dir, file_name), proj, mode, int(run_n), ext


def collate(data_dir=DATA_DIR, subjects_dir=SUBJECTS_DIR):
    """data/ directory -> {proj: ProjectData}."""
    projects = {}

    for path, proj, mode, run_n, ext in scan_data_dir(data_dir):
        project = projects.setdefault(proj, ProjectData())

        if mode in ("baseline", "shuffle"):
            with open(path, "r") as fd:
                ingest_runs_tsv(fd, mode, run_n, project)
        elif mode == "testinspect":
            if ext == "sqlite3":
                with sqlite3.connect(path) as con:
                    ingest_coverage_db(con, proj, project, subjects_dir)
            elif ext == "tsv":
                with open(path, "r") as fd:
                    ingest_rusage_tsv(fd, project)
            elif ext == "pkl":
                with open(path, "rb") as fd:
                    ingest_static_pickle(fd, project)

    return projects


def label_test(runs, n_runs=N_RUNS):
    """(req_runs, label) for one test's rerun tallies: the OD/NOD state
    machine. The label is None for an incomplete test."""
    base = runs.get("baseline", RunStats())
    shuf = runs.get("shuffle", RunStats())

    if base.n_runs != n_runs["baseline"] or shuf.n_runs != n_runs["shuffle"]:
        return 0, None

    if base.n_fail == 0:
        if shuf.n_fail == 0:
            return 0, NON_FLAKY
        return shuf.min_fail_run, OD_FLAKY

    if base.n_fail == base.n_runs:
        if shuf.n_fail == shuf.n_runs:
            return 0, NON_FLAKY
        return shuf.min_pass_run, OD_FLAKY

    return max(base.min_fail_run, base.min_pass_run), FLAKY


def _coverage_features_py(coverage, test_files, churn):
    n_lines = n_changes = n_src_lines = 0

    for file_name, lines in coverage.items():
        n_lines += len(lines)
        file_churn = churn.get(file_name, {})
        n_changes += sum(file_churn.get(line, 0) for line in lines)
        if file_name not in test_files:
            n_src_lines += len(lines)

    return n_lines, n_changes, n_src_lines


def coverage_features(coverage, test_files, churn):
    """(covered lines, churn-weighted covered changes, source-only
    covered lines): the 3 coverage features. Runs in the native module."""
    return native.load().coverage_features(coverage, test_files, churn)


def assemble_tests(projects, n_runs=N_RUNS):
    """{proj: ProjectData} -> the tests.json dict: projects and tests
    sorted case-insensitively, incomplete entries dropped."""
    tests = {}

    for proj in sorted(projects, key=str.lower):
        data = projects[proj]
        if not data.complete():
            continue

        tests_proj = {}
        for nid in sorted(data.tests, key=str.lower):
            rec = data.tests[nid]
            if not rec.complete():
                continue

            req_runs, label = label_test(rec.runs, n_runs)
            if label is None:
                continue

            tests_proj[nid] = (
                req_runs, label,
                *coverage_features(rec.coverage, data.test_files, data.churn),
                *rec.rusage,
                *data.fn_features[rec.fn_id],
            )

        if tests_proj:
            tests[proj] = tests_proj

    return tests


def write_tests(data_dir=DATA_DIR, out_file=TESTS_FILE,
                subjects_dir=SUBJECTS_DIR, n_runs=N_RUNS):
    tests = assemble_tests(collate(data_dir, subjects_dir), n_runs=n_runs)
    with atomic_write(out_file, "w") as fd:
        json.dump(tests, fd, indent=4)
    return tests
