"""The concurrency and shared-state rule pack (C101–C503), a copy of the
JAX package's ``analysis/rules_conc.py``.

It holds the port's host-side threaded substrate — the microbatcher's
dispatcher pool, the admission queue, the SLO monitor, the metrics
exporter, the flight ring, the supervisor, the fleet's router — to a
coherent locking story. Built on ``analysis/concurrency.py`` (thread
topology and lock-set model); the same model feeds
``obs/lockwatch.py``'s runtime reconciliation.

Catalog:

- C101 (error): shared mutable state — a ``self.`` attribute, module
  global (including ``G.attr``/``G[k]`` mutation), or closure cell —
  written from >= 2 thread roots (a multi-instance root, e.g. a
  dispatcher pool spawned in a loop, counts as two writers) with an
  empty or inconsistent guard set across the writes. ``__init__``
  writes are exempt (happens-before thread start), as are assignments
  installing the sync primitive itself.
- C201 (error): lock-order inversion — a cycle in the project-wide
  lock-order graph (lock B acquired while A is held, lexically or
  through resolvable calls via per-function may-acquire summaries).
  The finding names every lock in the cycle.
- C301 (warning): blocking call (``.result()``/``.join()``/``.wait()``
  on a foreign object, ``time.sleep``, subprocess/socket/file I/O,
  ``torch.cuda.*`` device calls) while holding a lock in J601's
  hot-path scope (serve/batcher.py, serve/queue.py, ``@hot_path``
  functions). The JAX package's ``jax.*`` marker becomes
  ``torch.cuda.*``: a device call is where a PyTorch host thread blocks.
  The port defines no ``hot_path`` marker, so that branch cannot fire
  on the port's own code; it is kept on purpose so that this pack's
  findings equal the JAX package's on the same files (the JAX fixture's
  C301 sits in a ``@hot_path`` function). The J pack's J601, which has
  no JAX oracle, scopes by module only.
  ``cond.wait()`` on the *held* condition is exempt — it releases.
- C401 (warning): non-async-signal-safe work in a ``signal.signal``
  handler: lock acquisition, printing/logging/file I/O, subprocess,
  telemetry emission, or blocking waits. ``Event.set()``-style flag
  flips, ``os.kill``/``sys.exit``, and plain assignments are safe.
- C501 (warning): ``os.fork()`` in a module that starts threads — the
  child inherits locked locks without their owner threads.
- C502 (warning): ``multiprocessing`` Process/Pool in a thread-starting
  module — the default fork start method snapshots foreign locks
  mid-flight (use the spawn context, or fork before threading).
- C503 (warning): ``subprocess.*(..., preexec_fn=...)`` — the hook runs
  between fork and exec where only async-signal-safe code is legal.
"""

from flake16_framework_tpu_torch.analysis import concurrency as conc
from flake16_framework_tpu_torch.analysis.engine import (
    ERROR, WARNING, RuleInfo,
)

RULES = {
    "C101": RuleInfo(
        "C101", ERROR,
        "shared state written from >=2 thread roots without a "
        "consistent lock"),
    "C201": RuleInfo(
        "C201", ERROR,
        "lock-order inversion cycle (potential deadlock)"),
    "C301": RuleInfo(
        "C301", WARNING,
        "blocking call while holding a hot-path lock"),
    "C401": RuleInfo(
        "C401", WARNING,
        "non-async-signal-safe work in a signal handler"),
    "C501": RuleInfo(
        "C501", WARNING,
        "os.fork() in a module that starts threads"),
    "C502": RuleInfo(
        "C502", WARNING,
        "multiprocessing (fork start method) in a thread-starting "
        "module"),
    "C503": RuleInfo(
        "C503", WARNING,
        "subprocess preexec_fn runs between fork and exec"),
}

# C301 scope — J601's hot-path surface (rules_torch keeps the same list).
_HOT_MODULES = ("serve/batcher.py", "serve/queue.py")

_BLOCK_DOTTED = {"time.sleep", "os.system", "os.read", "os.write",
                 "select.select"}
_BLOCK_PREFIXES = ("subprocess.", "socket.", "torch.cuda.")
_BLOCK_ATTRS = {"result", "join"}

_SIGNAL_SAFE_ATTRS = {"set", "is_set", "kill", "exit", "_exit", "append"}
_SIGNAL_SAFE_DOTTED = {"os.kill", "os._exit", "sys.exit", "signal.signal",
                       "signal.getsignal", "time.time", "time.monotonic"}

_MP_SPAWNERS = {"Process", "Pool"}


def _display(key):
    kind = key[0]
    if kind == "attr":
        return f"{key[2]}.self.{key[3]}"
    if kind == "global":
        return f"module global {key[2]!r}"
    return f"closure {key[3]!r} of {key[2]}()"


def _root_display(proj, key):
    if key == conc.MAIN_ROOT:
        return "main"
    r = proj.root_by_key(key)
    if r is None:
        return key
    label = r.name or f"{r.kind}@{r.path}:{r.node.lineno}"
    return label + ("[xN]" if r.multi else "")


def _hot(mm, fm):
    if mm.path.endswith(_HOT_MODULES):
        return True
    return any(d and (d == "hot_path" or d.endswith(".hot_path"))
               for d in fm.decorators)


def _blocking_marker(call, held):
    d = call.dotted
    if d and (d in _BLOCK_DOTTED or d.startswith(_BLOCK_PREFIXES)):
        return d
    if call.spec[0] == "name" and call.spec[1] == "open":
        return "open()"
    if call.attr in _BLOCK_ATTRS:
        return f".{call.attr}()"
    if call.attr == "wait" and call.recv_lock not in held:
        return ".wait()"
    return None


def _signal_unsafe(call):
    d = call.dotted
    if d in _SIGNAL_SAFE_DOTTED:
        return None
    if call.attr is not None:
        if call.attr in _SIGNAL_SAFE_ATTRS:
            return None
        if call.attr in ("acquire", "join", "wait", "write", "flush",
                         "put", "get", "print"):
            return f".{call.attr}()"
    if call.spec[0] == "name":
        if call.spec[1] in ("print", "open", "input"):
            return f"{call.spec[1]}()"
        return None  # helper call: resolved and walked via topology
    if d and d.startswith(("logging.", "subprocess.", "obs.", "torch.",
                           "sys.stdout", "sys.stderr")):
        return d
    if d == "open" or d in ("os.write", "os.system"):
        return d
    return None


def check_project(mods):
    findings = []
    by_path = {m.path: m for m in mods}
    proj = conc.build_project(mods)

    def emit(path, rule, node, message):
        mod = by_path.get(path)
        if mod is None:
            return
        findings.append(mod.finding(rule, RULES[rule].severity, node,
                                    message))

    _check_c101(proj, emit)
    _check_c201(proj, emit)
    _check_c301(proj, emit)
    _check_c401(proj, emit)
    _check_c5xx(proj, emit)
    return findings


def _check_c101(proj, emit):
    for key, writes in sorted(proj.shared_writes().items()):
        roots, weight = set(), 0
        for (fkey, w) in writes:
            for rk in proj.roots_of(*fkey):
                if rk.startswith("signal:"):
                    continue  # handlers interrupt, they don't race
                roots.add(rk)
        for rk in roots:
            if rk == conc.MAIN_ROOT:
                weight += 1
            else:
                r = proj.root_by_key(rk)
                weight += 2 if (r is not None and r.multi) else 1
        thread_roots = sorted(rk for rk in roots if rk != conc.MAIN_ROOT)
        if weight < 2 or not thread_roots:
            continue
        guard = None
        for (_, w) in writes:
            s = set(w.held)
            guard = s if guard is None else (guard & s)
        if guard:
            continue  # every write shares at least one lock
        ordered = sorted(writes, key=lambda fw: fw[1].node.lineno)
        anchor = next((w for (_, w) in ordered if not w.held),
                      ordered[0][1])
        names = ", ".join(_root_display(proj, rk)
                          for rk in sorted(roots))
        emit(key[1], "C101", anchor.node,
             f"{_display(key)} written from {len(roots)} thread "
             f"root(s) [{names}] with no consistent lock — guard every "
             f"write with one lock or confine writes to one thread")


def _check_c201(proj, emit):
    for cyc in proj.cycles():
        in_cyc = set(cyc)
        pairs = sorted(p for p in proj.edges
                       if p[0] in in_cyc and p[1] in in_cyc)
        if not pairs:
            continue
        path, node = proj.edges[pairs[0]]
        chain = " -> ".join(cyc + [cyc[0]])
        emit(path, "C201", node,
             f"lock-order inversion cycle: {chain} — threads taking "
             f"these locks in different orders can deadlock; pick one "
             f"global order")


def _check_c301(proj, emit):
    for mm in proj.mods.values():
        for fm in mm.funcs.values():
            if not _hot(mm, fm):
                continue
            for c in sorted(fm.calls, key=lambda c: c.node.lineno):
                if not c.held:
                    continue
                marker = _blocking_marker(c, c.held)
                if marker:
                    emit(mm.path, "C301", c.node,
                         f"blocking call {marker} while holding "
                         f"hot-path lock {c.held[-1]} — release before "
                         f"blocking or move the work off the lock")


def _check_c401(proj, emit):
    for mm in proj.mods.values():
        seen = set()
        for spec, handler_node, node in mm.signal_handlers:
            for fkey in proj.resolve_call(mm, spec):
                if fkey in seen:
                    continue
                seen.add(fkey)
                fm = proj.mods[fkey[0]].funcs[fkey[1]]
                if fm.direct_locks:
                    emit(mm.path, "C401", fm.node,
                         f"signal handler {fm.qualname}() acquires a "
                         f"lock — handlers interrupt the lock's owner")
                    continue
                for c in sorted(fm.calls, key=lambda c: c.node.lineno):
                    what = _signal_unsafe(c)
                    if what:
                        emit(fkey[0], "C401", c.node,
                             f"signal handler {fm.qualname}() calls "
                             f"{what} — not async-signal-safe; set a "
                             f"flag/Event and do the work outside")
                        break


def _check_c5xx(proj, emit):
    for mm in proj.mods.values():
        threaded = mm.has_threads
        for fm in mm.funcs.values():
            for c in sorted(fm.calls, key=lambda c: c.node.lineno):
                d = c.dotted
                if d == "os.fork" and threaded:
                    emit(mm.path, "C501", c.node,
                         "os.fork() after threads started: the child "
                         "inherits locked locks with no owner thread")
                elif (d and d.startswith("multiprocessing.")
                        and d.rsplit(".", 1)[-1] in _MP_SPAWNERS
                        and threaded):
                    emit(mm.path, "C502", c.node,
                         f"{d} in a thread-starting module: the fork "
                         f"start method snapshots foreign locks "
                         f"mid-flight — use the spawn context")
                elif d and d.startswith("subprocess.") and any(
                        kw.arg == "preexec_fn" for kw in c.node.keywords):
                    emit(mm.path, "C503", c.node,
                         "preexec_fn runs between fork and exec where "
                         "only async-signal-safe code is legal — use "
                         "process_group/env arguments instead")
