"""The port's lock-order witness (``obs/lockwatch.py``) against the JAX
package's, on the CPU, after the JAX package's
``tests/test_concurrency.py`` lockwatch cases: the round trip of a
nested acquisition, the inverted order and a dynamic cycle caught, stdlib
locks kept out of the subgraph check, dump and reset; the port's
``reconcile`` equal to the JAX package's on the same snapshots and
models, each package reconciling the other's dump; and a child process
run with ``F16_LOCKWATCH=<file>`` that imports the kernels' module first,
serves a few requests and dumps at exit, every lock the port makes at
import time traced and the observed order free of cycles."""

import json
import os
import subprocess
import sys
import threading

import pytest

from flake16_framework_tpu.obs import lockwatch as jlockwatch
from flake16_framework_tpu.obs import schema as jschema
from flake16_framework_tpu_torch.obs import lockwatch
from flake16_framework_tpu_torch.obs import schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMPTY = {"locks": {}, "edges": []}


@pytest.fixture
def traced():
    lockwatch.reset()
    lockwatch.install()
    yield
    lockwatch.uninstall()
    lockwatch.reset()


def _both(snap, model, root=None):
    got = lockwatch.reconcile(snap, model, root=root)
    assert got == jlockwatch.reconcile(snap, model, root=root)
    return got


def test_round_trip(traced):
    a = threading.Lock()
    b = threading.RLock()
    with a:
        with b:
            pass
    snap = lockwatch.snapshot()
    assert snap["schema"] == schema.LOCKWATCH_SCHEMA == \
        jschema.LOCKWATCH_SCHEMA
    sites = sorted(snap["locks"])
    assert len(sites) == 2
    assert all(os.path.basename(__file__) in s for s in sites)
    assert snap["locks"][sites[0]]["kind"] == "lock"
    assert snap["locks"][sites[1]]["kind"] == "rlock"
    (edge,) = snap["edges"]
    assert edge == [sites[0], sites[1], 1]
    model = {"locks": {"m:a": {"site": sites[0], "kind": "lock"},
                       "m:b": {"site": sites[1], "kind": "rlock"}},
             "edges": [["m:a", "m:b"]]}
    rec = _both(snap, model)
    assert rec["ok"] and rec["cycle"] is None
    assert rec["checked_edges"] == 1 and rec["violations"] == []
    assert rec["known_locks"] == ["m:a", "m:b"]
    # the same lock re-entered is no edge; a foreign release is counted
    r = threading.RLock()
    with r:
        with r:
            pass
    assert len(lockwatch.snapshot()["edges"]) == 1
    c = threading.Lock()
    c.acquire()
    t = threading.Thread(target=c.release)
    t.start()
    t.join()
    assert lockwatch.snapshot()["foreign_releases"] == 1


def test_inverted_order_and_unmodeled_edge(traced):
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    snap = lockwatch.snapshot()
    s_a, s_b = snap["edges"][0][:2]
    model = {"locks": {"m:a": {"site": s_a}, "m:b": {"site": s_b}},
             "edges": [["m:b", "m:a"]]}
    rec = _both(snap, model)
    assert not rec["ok"]
    assert rec["violations"] == [{"edge": ["m:a", "m:b"], "why": "inverted"}]
    rec = _both(snap, dict(model, edges=[]))
    assert rec["violations"] == [{"edge": ["m:a", "m:b"],
                                  "why": "unmodeled"}]


def test_dynamic_cycle_and_foreign_locks(traced):
    dynamic = {"schema": schema.LOCKWATCH_SCHEMA, "locks": {},
               "edges": [["x:1", "y:2", 3], ["y:2", "x:1", 1]]}
    rec = _both(dynamic, EMPTY)
    assert not rec["ok"] and sorted(rec["cycle"]) == ["x:1", "y:2"]
    import queue

    q = queue.Queue()
    q.put(1)
    q.get()
    rec = _both(lockwatch.snapshot(), EMPTY)
    assert rec["ok"] and rec["checked_edges"] == 0


@pytest.mark.parametrize("edges", [
    [], [["a", "b"]], [["a", "b"], ["b", "c"], ["c", "a"]],
    [["a", "b"], ["b", "c"], ["a", "c"]], [["a", "a"]],
    [["d", "e"], ["a", "b"], ["b", "a"], ["e", "d"]],
])
def test_graph_helpers_equal_jax(edges):
    from flake16_framework_tpu.analysis import concurrency as jconc

    assert lockwatch.find_edge_cycle(edges) == jconc.find_edge_cycle(edges)
    assert lockwatch.transitive_closure(edges) == \
        jconc.transitive_closure(edges)


def test_dump_reset_and_the_jax_dump(traced, tmp_path):
    lock = threading.Lock()
    with lock:
        pass
    out = str(tmp_path / "lw.json")
    assert lockwatch.dump(out) == out
    with open(out) as fd:
        doc = json.load(fd)
    assert doc["schema"] == schema.LOCKWATCH_SCHEMA and len(doc["locks"]) == 1
    lockwatch.reset()
    assert lockwatch.snapshot()["locks"] == {}
    # a dump the JAX package wrote reconciles alike in the port
    jdoc = {"schema": jschema.LOCKWATCH_SCHEMA, "pid": 1,
            "locks": {"p/x.py:3": {"kind": "lock", "created": 1}},
            "edges": [["p/x.py:3", "p/y.py:9", 2]], "foreign_releases": 0}
    model = {"locks": {"x": {"site": os.path.join(REPO, "p/x.py") + ":3"},
                       "y": {"site": os.path.join(REPO, "p/y.py") + ":9"}},
             "edges": [["x", "y"]]}
    rec = _both(jdoc, model, root=REPO)
    assert rec["ok"] and rec["known_locks"] == ["x"]


_CHILD = r'''
import sys
import flake16_framework_tpu_torch.kernels.build as build   # first
from flake16_framework_tpu_torch.obs import core, lockwatch
from flake16_framework_tpu_torch.serve.cli import serve_main
assert lockwatch.installed()
for lock in (build.COUNT_LOCK, core._lock, core._profiling):
    assert isinstance(lock, lockwatch._TracedLock), lock
sys.exit(serve_main(["--synth", "120", "--trees", "2", "--max-depth", "4",
                     "--requests", "16", "--rows", "4", "--clients", "4",
                     "--buckets", "4,8", "--kinds", "predict,shap",
                     "--json"], device="cpu"))
'''


def test_child_dumps_at_exit(tmp_path):
    out = str(tmp_path / "lockwatch.json")
    env = dict(os.environ, F16_LOCKWATCH=out, PYTHONPATH=REPO,
               F16_PERFDB="0", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as fd:
        dump = json.load(fd)
    assert dump["schema"] == jschema.LOCKWATCH_SCHEMA
    sites = {os.path.relpath(s.rpartition(":")[0], REPO).replace(os.sep, "/")
             for s in dump["locks"]}
    for module in ("kernels/build.py", "obs/core.py", "serve/queue.py",
                   "serve/batcher.py", "serve/service.py"):
        assert f"flake16_framework_tpu_torch/{module}" in sites, sorted(sites)
    assert dump["edges"]
    rec = _both(dump, EMPTY, root=REPO)
    assert rec["ok"] and rec["cycle"] is None
    # armed only by the variable: without it the factories are stdlib's
    env.pop("F16_LOCKWATCH")
    check = ("import threading, flake16_framework_tpu_torch as p; "
             "from flake16_framework_tpu_torch.obs import lockwatch; "
             "assert not lockwatch.installed(); "
             "assert threading.Lock.__module__ != lockwatch.__name__")
    proc = subprocess.run([sys.executable, "-c", check], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
