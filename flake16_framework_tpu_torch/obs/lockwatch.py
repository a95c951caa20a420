"""lockwatch — the runtime lock-order witness.

Opt-in via ``F16_LOCKWATCH`` (armed when the package is first imported,
before any of its locks is created): wraps the ``threading.Lock``/
``RLock`` factories with a tracing proxy that records, per thread, the
stack of held locks and every *order edge* — lock B acquired while A is
held. Each lock is identified by its **creation site** (``path:lineno``
of the first non-``threading`` frame at construction), the join key of
the static lock model (``analysis/concurrency.build_lock_model``), so
:func:`reconcile` can check that the dynamic graph observed during a
serve drill is cycle-free AND a subgraph of a statically allowed order.

Because ``Condition``/``Event``/``Semaphore``/``queue.Queue`` build on
the patched factories *by runtime lookup*, their internal locks are
traced too: package-created sync objects map to package sites; locks
minted inside the stdlib map to stdlib sites and are treated as
*foreign* — they join the cycle check (a real inversion is a real
deadlock wherever the locks live) but not the subgraph check.

``F16_LOCKWATCH=1`` dumps ``lockwatch.json`` (schema
``flake16-lockwatch-v1``, the JAX package's) into the CWD at exit; any
other non-empty value is the output path. The tracer's own state is
guarded by a raw ``_thread`` lock so it can never appear in its own
graph.
"""

import atexit
import json
import os
import sys
import threading
import _thread

from flake16_framework_tpu_torch.obs import schema

ENV_VAR = "F16_LOCKWATCH"

_state_lock = _thread.allocate_lock()
_tls = threading.local()
_installed = False
_orig = {}
_dump_path = None
_locks = {}      # site -> {"kind": str, "created": int}
_edges = {}      # (site_a, site_b) -> count
_foreign_releases = 0

_THIS_FILE = os.path.abspath(__file__)


def _norm(path):
    apath = os.path.abspath(path)
    cwd = os.getcwd()
    if apath == cwd or apath.startswith(cwd + os.sep):
        apath = os.path.relpath(apath, cwd)
    return apath.replace(os.sep, "/")


def _creation_site():
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.endswith(("threading.py",)) \
                and os.path.abspath(fn) != _THIS_FILE:
            return f"{_norm(fn)}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>:0"


def _held_stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _note_acquire(site):
    stack = _held_stack()
    with _state_lock:
        for held in dict.fromkeys(stack):  # dedup, keep order
            if held != site:               # reentrancy is not an edge
                key = (held, site)
                _edges[key] = _edges.get(key, 0) + 1
    stack.append(site)


def _note_release(site):
    global _foreign_releases
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == site:
            del stack[i]
            return
    with _state_lock:
        _foreign_releases += 1  # released by a non-acquiring thread


class _TracedLock:
    """Delegating proxy over a real lock. Only the entry points that
    change ownership are intercepted; everything else (``locked``,
    ``_is_owned``, ``_release_save``/``_acquire_restore`` — the RLock
    protocol Condition.wait borrows) reaches the inner lock through
    ``__getattr__``. A waiting thread is blocked, not running user
    code, so leaving the site on this thread's stack across ``wait()``
    keeps the held-set sound."""

    __slots__ = ("_f16_inner", "_f16_site")

    def __init__(self, inner, site):
        object.__setattr__(self, "_f16_inner", inner)
        object.__setattr__(self, "_f16_site", site)

    def acquire(self, *args, **kw):
        got = self._f16_inner.acquire(*args, **kw)
        if got:
            _note_acquire(self._f16_site)
        return got

    def release(self):
        self._f16_inner.release()
        _note_release(self._f16_site)

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<f16-lockwatch {self._f16_site} {self._f16_inner!r}>"

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_f16_inner"), name)


def _factory(orig, kind):
    def make(*args, **kw):
        inner = orig(*args, **kw)
        site = _creation_site()
        with _state_lock:
            rec = _locks.setdefault(site, {"kind": kind, "created": 0})
            rec["created"] += 1
        return _TracedLock(inner, site)
    make._f16_orig = orig
    return make


def install():
    """Patch the threading lock factories. Idempotent."""
    global _installed
    if _installed:
        return
    _orig["Lock"] = threading.Lock
    _orig["RLock"] = threading.RLock
    threading.Lock = _factory(threading.Lock, "lock")
    threading.RLock = _factory(threading.RLock, "rlock")
    _installed = True


def uninstall():
    """Restore the original factories (existing proxies keep working)."""
    global _installed
    if not _installed:
        return
    threading.Lock = _orig.pop("Lock")
    threading.RLock = _orig.pop("RLock")
    _installed = False


def reset():
    """Drop recorded locks/edges (between in-process experiments)."""
    global _foreign_releases
    with _state_lock:
        _locks.clear()
        _edges.clear()
        _foreign_releases = 0


def installed():
    return _installed


def snapshot():
    """The dynamic lock-order document (schema flake16-lockwatch-v1)."""
    with _state_lock:
        locks = {s: dict(rec) for s, rec in _locks.items()}
        edges = sorted([a, b, n] for (a, b), n in _edges.items())
        foreign = _foreign_releases
    return {
        "schema": schema.LOCKWATCH_SCHEMA,
        "pid": os.getpid(),
        "locks": locks,
        "edges": edges,
        "foreign_releases": foreign,
    }


def dump(path=None):
    """Write the snapshot atomically; returns the path."""
    from flake16_framework_tpu_torch.utils.atomic import atomic_write

    path = path or _dump_path or "lockwatch.json"
    with atomic_write(path, "w", encoding="utf-8") as fd:
        json.dump(snapshot(), fd, indent=1, sort_keys=True)
    return path


def maybe_install_from_env():
    """Arm from ``F16_LOCKWATCH`` and register the exit dump. Called at
    obs package import, BEFORE obs/core creates its module locks (and
    the package's ``__init__`` imports obs before anything else)."""
    global _dump_path
    val = os.environ.get(ENV_VAR, "")
    if val in ("", "0"):
        return False
    _dump_path = val if val not in ("1", "true", "yes") \
        else "lockwatch.json"
    install()
    atexit.register(_atexit_dump)
    return True


def _atexit_dump():
    try:
        dump()
    except Exception:
        pass  # a failed witness dump must never mask the real exit


# -- reconciliation against a static lock model ---------------------------


def _rel_site(site, root):
    if not root:
        return site
    path, _, lineno = site.rpartition(":")
    apath = os.path.abspath(root)
    if os.path.isabs(path) and (path == apath
                                or path.startswith(apath + os.sep)):
        path = os.path.relpath(path, apath).replace(os.sep, "/")
    return f"{path}:{lineno}"


def reconcile(dynamic, static_model, root=None):
    """Check a :func:`snapshot` document against the static lock model
    (``analysis/concurrency.build_lock_model``, the JAX package's
    format). Returns::

        {"ok": bool, "cycle": [site, ...] | None,
         "known_locks": [lock_id, ...],           # dynamically observed
         "violations": [{"edge": [idA, idB], "why": ...}, ...],
         "checked_edges": int, "foreign_edges": int}

    ``ok`` means the full dynamic graph (foreign locks included) is
    cycle-free AND every edge between statically known locks lies on a
    statically allowed order path: ``why="inverted"`` marks a dynamic
    edge whose *reverse* the static model orders (a latent deadlock
    against some other code path), ``why="unmodeled"`` an edge the
    static pass never derived (its call-graph blind spot — model it or
    fix the nesting). ``root`` relativizes absolute sites recorded by a
    child process run from a different CWD."""
    from flake16_framework_tpu_torch.analysis import concurrency as conc

    dyn_edges = [(e[0], e[1]) for e in dynamic.get("edges", ())]
    cycle = conc.find_edge_cycle(dyn_edges)

    site_to_id = {}
    for lid, rec in static_model.get("locks", {}).items():
        site_to_id[_rel_site(rec["site"], root)] = lid
    closure = conc.transitive_closure(static_model.get("edges", ()))

    known, violations, checked, foreign = set(), [], 0, 0
    for (a, b) in dyn_edges:
        ia = site_to_id.get(_rel_site(a, root))
        ib = site_to_id.get(_rel_site(b, root))
        if ia is None or ib is None:
            foreign += 1
            continue
        checked += 1
        if ib in closure.get(ia, ()):
            continue
        why = "inverted" if ia in closure.get(ib, ()) else "unmodeled"
        violations.append({"edge": [ia, ib], "why": why})
    for site in dynamic.get("locks", ()):
        lid = site_to_id.get(_rel_site(site, root))
        if lid is not None:
            known.add(lid)

    return {
        "ok": cycle is None and not violations,
        "cycle": cycle,
        "known_locks": sorted(known),
        "violations": violations,
        "checked_edges": checked,
        "foreign_edges": foreign,
    }
