"""Rule pack 1 — PyTorch host hygiene (J-rules), the port's counterpart
of the JAX package's ``analysis/rules_jax.py``, with the same rule ids.

Each JAX rule whose defect exists in a PyTorch program is kept, in
PyTorch spellings:

- J202: iteration over a set — order-unstable schedules (the order of a
  sweep, of a plan's members, of a journal's records) make runs differ.
- J401: a leftover ``breakpoint()`` / ``pdb.set_trace()`` — a run on
  the card stops there, waiting on a terminal nobody watches.
- J402: ``torch.cuda.synchronize()`` or ``.cpu()`` inside a loop body —
  one host sync an iteration serializes the launch queue (the JAX
  rule's ``block_until_ready`` in a loop).
- J501: a broad ``except`` around a kernel launch (the wrappers
  ``cum_hists`` and ``unit_shap``) or a ``torch.cuda`` call that does
  not route the failure through ``flake16_framework_tpu_torch.
  resilience`` (classify / guard) — device faults vanish unclassified.
- J601: ``.item()``, ``.cpu()``, ``.tolist()`` or
  ``torch.cuda.synchronize()`` in serve hot-path scope
  (``serve/batcher.py`` and ``serve/queue.py``; the JAX rule's
  ``@hot_path`` functions have no counterpart, since the port defines
  no such marker) — a blocking device->host read
  stalls the microbatch pipeline; the one sanctioned crossing per
  microbatch carries an inline ``f16lint: disable=J601``.
- J701: a write-mode ``open(..., "w"/"wb")`` outside
  ``utils/atomic.py`` and ``resilience/journal.py`` — a kill mid-write
  tears the artifact; durable writes go through ``utils.atomic_write``
  (tmp + fsync + rename). Append mode is exempt (the O_APPEND JSONL
  sinks' whole-line semantics are the sanctioned crash contract).

No counterpart, so not ported (a rule that can never fire is no rule):
J101-J104 (host syncs on traced values under ``jax.jit``), J201
(unhashable ``static_argnums``), J203 (``jax.jit`` in a loop) and J301
(float64 silently downcast when x64 is off). The port traces nothing
under a jit, and it takes float64 on purpose where XLA:CPU's bits
demand it (``ops/preprocess.py``).
"""

import ast

from flake16_framework_tpu_torch.analysis.engine import (
    ERROR, WARNING, RuleInfo,
)

RULES = {r.id: r for r in (
    RuleInfo("J202", WARNING,
             "iteration over a set — nondeterministic order; feeding"
             " sweep schedules or records makes runs differ"),
    RuleInfo("J401", ERROR,
             "leftover breakpoint()/pdb.set_trace()"),
    RuleInfo("J402", WARNING,
             "torch.cuda.synchronize()/.cpu() inside a loop body —"
             " serializes the launch queue (one host sync per"
             " iteration)"),
    RuleInfo("J501", WARNING,
             "broad except around a kernel launch or cuda call without"
             " routing the failure through the resilience layer — faults"
             " vanish unclassified instead of retrying/quarantining"),
    RuleInfo("J601", WARNING,
             "blocking device->host read in serve hot-path scope —"
             " stalls the microbatch pipeline; reads belong at the batch"
             " boundary (one amortized crossing per microbatch)"),
    RuleInfo("J701", WARNING,
             "write-mode open() outside utils.atomic_write — a crash or"
             " kill mid-write tears the durable artifact; use"
             " atomic_write (tmp + fsync + rename)"),
)}

_DEBUG_CALLS = {"breakpoint", "pdb.set_trace"}

# J402/J601: calls that drain the launch queue or read device memory.
_SYNC = "torch.cuda.synchronize"
_LOOP_SYNC_ATTRS = {"cpu"}
_HOT_ATTRS = {"item", "cpu", "tolist"}

# J501: the kernel wrappers (kernels/hist.py, kernels/treeshap_unit.py),
# matched by name under any import alias, and every torch.cuda call.
_KERNEL_WRAPPERS = {"cum_hists", "unit_shap"}
_CUDA_ROOT = "torch.cuda."
# Any call resolving under this package counts as "routed": the
# classifier (faults.classify*), the guard, ...
_RESILIENCE_ROOT = "flake16_framework_tpu_torch.resilience"
_BROAD_EXCEPTS = {"Exception", "BaseException", "builtins.Exception",
                  "builtins.BaseException"}

# J601: modules that are hot-path scope by location (repo-relative posix).
_HOT_MODULES = ("batcher.py", "queue.py")

# J701: the durability layer itself — raw fd control (fsync'd appends,
# tmp-file plumbing) is its job, so write-mode open() is sanctioned here
# and nowhere else.
_ATOMIC_EXEMPT = ("utils/atomic.py", "resilience/journal.py")


def _import_aliases(tree):
    """local name -> dotted module path, from import statements."""
    aliases = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _dotted(node, aliases):
    """Resolve Name/Attribute chains to a dotted path with import aliases
    applied (``tc.synchronize`` -> ``torch.cuda.synchronize``); None for
    non-chains."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    parts.reverse()
    root = aliases.get(parts[0], parts[0])
    return ".".join([root] + parts[1:])


def _is_set_expr(node, aliases):
    if isinstance(node, ast.Set):
        return True
    if isinstance(node, ast.Call):
        return _dotted(node.func, aliases) in ("set", "frozenset")
    return False


def _method(node):
    """The attribute name of a method call with no arguments
    (``x.cpu()`` -> "cpu"), else None."""
    if isinstance(node.func, ast.Attribute) and not node.args \
            and not node.keywords:
        return node.func.attr
    return None


def check_module(mod):
    aliases = _import_aliases(mod.tree)
    findings = []

    def emit(rule_id, node, message):
        findings.append(
            mod.finding(rule_id, RULES[rule_id].severity, node, message))

    # -- whole-module rules ---------------------------------------------
    loop_depth = 0

    def walk(node):
        nonlocal loop_depth
        is_loop = isinstance(node, (ast.For, ast.While, ast.AsyncFor))
        if is_loop:
            loop_depth += 1
        if isinstance(node, ast.Call):
            d = _dotted(node.func, aliases)
            if d in _DEBUG_CALLS:
                emit("J401", node, f"{d}() left in code")
            if loop_depth and d == _SYNC:
                emit("J402", node, f"{d}() inside a loop body")
            elif loop_depth and _method(node) in _LOOP_SYNC_ATTRS:
                emit("J402", node,
                     f".{_method(node)}() inside a loop body")
        if isinstance(node, (ast.For, ast.AsyncFor)) \
                and _is_set_expr(node.iter, aliases):
            emit("J202", node.iter, "iterating a set (unordered); use "
                 "sorted(...) for a deterministic schedule")
        if isinstance(node, ast.comprehension) \
                and _is_set_expr(node.iter, aliases):
            emit("J202", node.iter, "comprehension over a set (unordered);"
                 " use sorted(...)")
        for child in ast.iter_child_nodes(node):
            walk(child)
        if is_loop:
            loop_depth -= 1

    walk(mod.tree)

    # -- J501: unguarded broad excepts around kernel launches -----------

    def is_dispatch(call):
        d = _dotted(call.func, aliases) or ""
        if d.startswith(_CUDA_ROOT):
            return True
        name = d.rsplit(".", 1)[-1]
        return name in _KERNEL_WRAPPERS or _method(call) == "cuda"

    def has_dispatch(stmts):
        return any(isinstance(sub, ast.Call) and is_dispatch(sub)
                   for stmt in stmts for sub in ast.walk(stmt))

    def routes_resilience(handler):
        for sub in ast.walk(handler):
            if isinstance(sub, ast.Call):
                d = _dotted(sub.func, aliases)
                if d and (d == _RESILIENCE_ROOT
                          or d.startswith(_RESILIENCE_ROOT + ".")):
                    return True
        return False

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Try) or not has_dispatch(node.body):
            continue
        for h in node.handlers:
            broad = h.type is None \
                or _dotted(h.type, aliases) in _BROAD_EXCEPTS
            if broad and not routes_resilience(h):
                emit("J501", h,
                     "except Exception around a kernel launch or cuda "
                     "call must route the failure through "
                     "flake16_framework_tpu_torch.resilience (classify / "
                     "guard), not swallow it")

    # -- J601: blocking reads in serve hot-path scope -------------------
    hot_module = ("serve/" in mod.path
                  and mod.path.rsplit("/", 1)[-1] in _HOT_MODULES)

    def scan_hot(root, where):
        for node in ast.walk(root):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func, aliases)
            if d == _SYNC:
                emit("J601", node,
                     f"{d}() in serve hot path ({where}) — drains the "
                     "launch queue; move it to the batch boundary")
            elif _method(node) in _HOT_ATTRS:
                emit("J601", node,
                     f".{_method(node)}() in serve hot path ({where}) — "
                     "blocking device->host read; move it to the batch "
                     "boundary")

    if hot_module:
        scan_hot(mod.tree, f"hot module {mod.path.rsplit('/', 1)[-1]}")

    # -- J701: durable writes bypassing utils.atomic_write --------------
    if not mod.path.endswith(_ATOMIC_EXEMPT):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if _dotted(node.func, aliases) not in ("open", "io.open"):
                continue
            mode = node.args[1] if len(node.args) >= 2 else None
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            if isinstance(mode, ast.Constant) \
                    and isinstance(mode.value, str) \
                    and ("w" in mode.value or "x" in mode.value):
                emit("J701", node,
                     f"open(..., {mode.value!r}) writes a durable "
                     "artifact without tmp+fsync+rename; wrap it in "
                     "utils.atomic_write")
    return findings
