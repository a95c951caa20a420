"""testinspect: one instrumented run collecting the 13 measured features (a
copy of the JAX package's ``plugins/testinspect.py``).

Contract (consumed by runner/collate.py). Flag ``--testinspect=<base>``
emits three artifacts:

- ``<base>.sqlite3`` — per-test line coverage as a coverage.py-5.x-schema DB:
  ``context(id, context)`` (context = nodeid), ``file(id, path)`` (absolute
  paths; the collator re-roots them), ``line_bits(file_id, context_id,
  numbits)`` with the numbits bitset encoding (bit k of byte n = line 8n+k).
  Tracing is ``sys.monitoring`` (PEP 669) — no coverage.py in the subject
  venv; out-of-tree code locations are DISABLE'd at first hit so the hot
  callback only fires for project files.
- ``<base>.tsv`` — per test: 6 rusage floats + nodeid, in FEATURE_NAMES[3:9]
  order (Execution Time, Read Count, Write Count, Context Switches,
  Max. Threads, Max. Memory), measured around the whole runtest protocol
  with ``resource.getrusage`` + psutil.
- ``<base>.pkl`` — ``(test_fn_ids: nodeid -> fid, test_fn_data: fid ->
  7 static features, test_files: set of relative test file paths,
  churn: file -> {line: change count})``; static features from
  plugins/static_features.py, churn from plugins/churn.py.

Paths inside ``test_files``/``churn`` are relative to the pytest rootdir
(the subject checkout — runner/containers.py runs pytest from there), which
is the same space the collator re-roots coverage paths into.
"""

import os
import pickle
import resource
import sqlite3
import sys
import time

import pytest

from flake16_framework_tpu_torch.plugins.churn import git_churn
from flake16_framework_tpu_torch.plugins.static_features import ModuleAnalyzer

# sys.monitoring is PEP 669 (Python 3.12+). The plugin must stay importable
# on older interpreters, so the flag alone fails there, with a clean usage
# error below.
_MONITORING = getattr(sys, "monitoring", None)
_TOOL = _MONITORING.COVERAGE_ID if _MONITORING is not None else None


def lines_to_numbits(lines):
    """Encode a line-number set as a coverage.py numbits blob (inverse of
    runner/collate.numbits_to_lines)."""
    if not lines:
        return b""
    blob = bytearray(max(lines) // 8 + 1)
    for line in lines:
        blob[line // 8] |= 1 << (line % 8)
    return bytes(blob)


def pytest_addoption(parser):
    group = parser.getgroup("testinspect")
    group.addoption("--testinspect", action="store", default=None,
                    help="collect features; write <val>.{sqlite3,tsv,pkl}")


def pytest_configure(config):
    base = config.getoption("--testinspect")
    if base:
        if _MONITORING is None:
            raise pytest.UsageError(
                "--testinspect requires Python 3.12+ (line coverage is "
                "traced via sys.monitoring, PEP 669); this interpreter is "
                + sys.version.split()[0]
            )
        config.pluginmanager.register(
            _TestInspect(base, str(config.rootpath)), "_testinspect_impl"
        )


class _LineTracer:
    """sys.monitoring LINE tracer with per-test context switching."""

    def __init__(self, root):
        self.root = root.rstrip(os.sep) + os.sep
        self.current = None  # set of (abs file, line) for the live test
        self._own = os.path.dirname(os.path.abspath(__file__)) + os.sep

    def start(self):
        sys.monitoring.use_tool_id(_TOOL, "testinspect")
        sys.monitoring.register_callback(
            _TOOL, sys.monitoring.events.LINE, self._on_line
        )
        sys.monitoring.set_events(_TOOL, sys.monitoring.events.LINE)

    def stop(self):
        sys.monitoring.set_events(_TOOL, 0)
        sys.monitoring.register_callback(
            _TOOL, sys.monitoring.events.LINE, None
        )
        sys.monitoring.free_tool_id(_TOOL)

    def _on_line(self, code, line):
        fn = code.co_filename
        if not fn.startswith(self.root) or fn.startswith(self._own):
            return sys.monitoring.DISABLE  # never project code: drop forever
        if self.current is not None:
            self.current.add((fn, line))
        return None


class _TestInspect:
    def __init__(self, base, root):
        self.base = base
        self.root = root
        self.tracer = _LineTracer(root)
        self.analyzer = ModuleAnalyzer()
        self.coverage = {}   # nodeid -> set of (abs file, line)
        self.rusage = {}     # nodeid -> [6 floats], insertion order
        self.fn_ids = {}     # nodeid -> fid
        self.fn_data = {}    # fid -> 7-tuple
        self.test_files = set()
        self._fid_by_fn = {}

    # -- session lifecycle --------------------------------------------------

    def pytest_sessionstart(self, session):
        self.tracer.start()

    def pytest_sessionfinish(self, session, exitstatus):
        self.tracer.stop()
        self._write_sqlite()
        self._write_tsv()
        self._write_pickle()

    # -- per-test instrumentation ------------------------------------------

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_protocol(self, item, nextitem):
        import psutil

        self._record_static(item)

        cov = set()
        self.tracer.current = cov
        proc = psutil.Process()
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        threads0 = proc.num_threads()
        t0 = time.perf_counter()
        try:
            return (yield)
        finally:
            elapsed = time.perf_counter() - t0
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            self.tracer.current = None
            self.coverage[item.nodeid] = cov
            self.rusage[item.nodeid] = [
                elapsed,
                float(ru1.ru_inblock - ru0.ru_inblock),
                float(ru1.ru_oublock - ru0.ru_oublock),
                float((ru1.ru_nvcsw + ru1.ru_nivcsw)
                      - (ru0.ru_nvcsw + ru0.ru_nivcsw)),
                float(max(threads0, proc.num_threads())),
                float(ru1.ru_maxrss),
            ]

    def _record_static(self, item):
        fn = getattr(item, "function", None)
        code = getattr(fn, "__code__", None)
        if code is None:
            return
        path = code.co_filename
        self.test_files.add(os.path.relpath(path, start=self.root))
        key = (path, fn.__name__, code.co_firstlineno)
        if key not in self._fid_by_fn:
            feats = self.analyzer.features_for(
                path, fn.__name__, code.co_firstlineno
            )
            if feats is None:
                return
            # fids start at 1: the collation's completeness check keeps the
            # reference's falsy semantics, under which a test with fn id 0
            # would be silently dropped.
            fid = len(self._fid_by_fn) + 1
            self._fid_by_fn[key] = fid
            self.fn_data[fid] = feats
        self.fn_ids[item.nodeid] = self._fid_by_fn[key]

    # -- artifact writers ---------------------------------------------------

    def _write_sqlite(self):
        path = self.base + ".sqlite3"
        if os.path.exists(path):
            os.remove(path)
        con = sqlite3.connect(path)
        con.executescript(
            "CREATE TABLE context (id INTEGER PRIMARY KEY, context TEXT);"
            "CREATE TABLE file (id INTEGER PRIMARY KEY, path TEXT);"
            "CREATE TABLE line_bits (file_id INTEGER, context_id INTEGER,"
            "                        numbits BLOB);"
        )
        file_ids = {}
        for ctx_id, (nid, cov) in enumerate(self.coverage.items(), start=1):
            con.execute("INSERT INTO context VALUES (?, ?)", (ctx_id, nid))
            per_file = {}
            for fn, line in cov:
                per_file.setdefault(fn, set()).add(line)
            for fn, lines in per_file.items():
                if fn not in file_ids:
                    file_ids[fn] = len(file_ids) + 1
                    con.execute("INSERT INTO file VALUES (?, ?)",
                                (file_ids[fn], fn))
                con.execute(
                    "INSERT INTO line_bits VALUES (?, ?, ?)",
                    (file_ids[fn], ctx_id, lines_to_numbits(lines)),
                )
        con.commit()
        con.close()

    def _write_tsv(self):
        # standalone plugin (runs inside subject venvs): no package
        # imports, so no utils.atomic_write here
        with open(self.base + ".tsv", "w") as fd:  # f16lint: disable=J701
            for nid, vals in self.rusage.items():
                fd.write("\t".join(str(v) for v in vals) + f"\t{nid}\n")

    def _write_pickle(self):
        churn = git_churn(self.root) or {}
        # standalone plugin: no package imports, no utils.atomic_write
        with open(self.base + ".pkl", "wb") as fd:  # f16lint: disable=J701
            pickle.dump(
                (self.fn_ids, self.fn_data, self.test_files, churn), fd
            )
