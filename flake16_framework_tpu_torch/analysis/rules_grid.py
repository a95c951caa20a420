"""Rule pack 2 — the config grid's pre-flight (G-rules), a copy of the
JAX package's ``analysis/rules_grid.py`` against the port's own
``config.py``.

Statically validate the full config grid (the paper's 2x2x3x6x3 = 216,
derived from config.py's axes, not pinned) against the implemented
kernel registry before a multi-hour run: a malformed config axis must
fail in seconds on the host, not hours into a run on the card. Nothing
in this module imports torch.

Checks, each its own rule id:

- G101 grid-shape: five non-empty dict axes; the axes multiply out to
  the same count ``config.iter_config_keys()`` enumerates (the default
  expected size derives from the enumeration, so adding an axis value
  in config.py moves BOTH sides together and a *skew* between the axes
  and the enumeration is what actually fires).
- G102 kernel-registry: preprocessing/balancing codes are EXACTLY
  ``range(len(axis))``; the implemented dispatch's arity must match the
  axis size; every (prep, bal, model) triple resolves. The JAX package
  reads the arity off a ``lax.switch`` branch tuple. The port dispatches
  with ``if code == PREP_X`` chains (``ops/preprocess.fit_preprocess``,
  ``ops/resample.resample``), so here the arity is the count of distinct
  code constants the dispatcher compares its code with.
- G103 static-hashability: model specs and feature-set column tuples
  must be hashable — they key the per-family caches of the sweep and the
  planner's family plans.
- G104 padded-shapes: feature columns are unique ints inside
  ``range(n_features)`` (column indexing into the [N, F] matrix).
- G105 span-collision: a telemetry span name declared in two different
  modules merges unrelated timings in ``report`` — span names must be
  unique per module.
- G106 knob-census: every ``F16_*`` env read in the package must be
  declared in the ``KNOBS`` registry below (name + value validator), a
  declared knob must still be read somewhere (stale entries rot into
  folklore), and any knob SET in the current environment must hold a
  value its validator accepts — a typo'd grower arm
  (``F16_ENSEMBLE_GROWER=hsit``) fails the pre-flight in seconds on the
  host instead of raising hours into a sweep. ``KNOBS`` is the census
  of the variables the *port* reads, not the JAX package's.
- G107 executor-scope dispatch loop (per-module): a Python
  ``for``/``while`` loop that calls ``run_config`` inside a function
  marked ``@executor_scope`` re-introduces the per-config round-trip a
  plan executor exists to delete. The port defines no
  ``executor_scope`` marker, so G107 cannot fire on the port's own code;
  it is kept on purpose so that this pack's catalog and findings equal
  the JAX package's on the same files (the JAX fixture marks a function
  so, and the tests hold the two packs finding for finding).
- G108 tunable-constant census (per-module): a module-level ALL-CAPS
  integer literal whose name carries a tunable suffix (BATCH, CHUNK,
  BLK, TILE, BINS, WINDOW, WIDTH) in a torch-importing module (the JAX
  package asks "imports jax") is a hardcoded kernel tunable the tuner
  cannot see. Register the matching ``F16_<NAME>`` knob in the port's
  ``perf/tuner.py`` KNOBSPACE and derive the constant from its env
  read, or suppress the finding inline with the reason the constant is
  not a tunable (a width compiled into a kernel, a fidelity constant).

``preflight_grid`` is callable with injected axes so tests (and future
config loaders) can validate a candidate grid without editing config.py.
"""

import ast
import os

from flake16_framework_tpu_torch.analysis.engine import (
    ERROR, WARNING, Finding, RuleInfo, normpath,
)

RULES = {r.id: r for r in (
    RuleInfo("G101", ERROR, "grid axes malformed or config count drifted"),
    RuleInfo("G102", ERROR,
             "axis code does not resolve to a real kernel (dispatch"
             " registry mismatch)"),
    RuleInfo("G103", ERROR,
             "static spec unhashable — defeats the per-family caches"
             " (a plan or cache entry per config)"),
    RuleInfo("G104", ERROR, "feature columns out of range or duplicated"),
    RuleInfo("G105", WARNING,
             "telemetry span name declared in more than one module"),
    RuleInfo("G106", ERROR,
             "env knob census: undeclared F16_* read, stale registry"
             " entry, or invalid knob value in the current environment"),
    RuleInfo("G107", WARNING,
             "per-config dispatch loop inside @executor_scope — the"
             " planner/executor's whole-plan program replaced this"),
    RuleInfo("G108", WARNING,
             "tunable kernel constant hardcoded without a KnobSpace"
             " registration — the tuner cannot search what it cannot see"),
)}

# The declared F16_* knob registry (G106): name -> (kind, detail).
# kind "enum": detail is the allowed value tuple; "int"/"float": detail is
# the inclusive minimum, or an inclusive (minimum, maximum) pair; "str":
# free-form (censused but not value-checked).
# The census of the variables the port reads: the JAX package's
# registrations with no reader here (the SHAP block, refinement tile and
# hist-implementation knobs) are left out, since a declared knob no module
# reads is G106's stale entry.
KNOBS = {
    "F16_TELEMETRY": ("str", None),
    "F16_TELEMETRY_HEARTBEAT_S": ("float", 0.0),
    "F16_FAULT_INJECT": ("str", None),
    "F16_FAULT_MAX_ATTEMPTS": ("int", 1),
    "F16_FAULT_BACKOFF_S": ("float", 0.0),
    "F16_FAULT_BACKOFF_MAX_S": ("float", 0.0),
    "F16_FAULT_ENVELOPE_S": ("float", 0.0),
    # grower tier and the hist grower's window width (ops/trees.py);
    # "0" on the CPU means no pin, as in the JAX package.
    "F16_ENSEMBLE_GROWER": ("enum", ("hist", "exact")),
    "F16_HIST_NODE_BATCH": ("int", 1),
    "F16_HIST_NODE_BATCH_CPU": ("int", 0),
    # the model-changing arms, as the JAX package declares them, but for
    # the bins' upper bound: they are uint8 and K1 takes at most 256
    # (ops/trees.py hist_bins, ops/preprocess.py pca_impl_of).
    "F16_HIST_BINS": ("int", (2, 256)),
    "F16_HIST_REFINE": ("enum", ("exact", "edge")),
    "F16_ET_DRAW": ("enum", ("value", "rank")),
    "F16_FEATURE_QUOTA": ("enum", ("sklearn", "informative")),
    "F16_PCA_IMPL": ("enum", ("", "svd", "eigh")),
    # predict's walk and the windows walk's width (ops/trees.py
    # predict_impl, predict_window), as the JAX package declares them.
    "F16_PREDICT_IMPL": ("enum", ("gather", "windows")),
    "F16_PREDICT_WINDOW": ("int", 1),
    # observability: per-request trace sampling rate (obs/core.py), the
    # torch.profiler capture directory of the plan and serve hooks, and
    # the flight ring's arming path (obs/flight.py).
    "F16_TRACE_SAMPLE": ("float", 0.0),
    "F16_XPROF": ("str", None),
    "F16_FLIGHT": ("str", None),
    # The performance database's path (obs/perfdb.py): a file path, ""
    # for the _scratch default, "0" disables the consult.
    "F16_PERFDB": ("str", None),
    # The runtime lock-order witness (obs/lockwatch.py): "1" arms the
    # tracer and dumps lockwatch.json to the CWD at exit; any other
    # non-empty value is the dump path; ""/"0" leaves it off.
    "F16_LOCKWATCH": ("str", None),
    # Serving fleet: F16_FLEET_WORKER is set by the fleet in each
    # worker's env to its index, never by hand; the rest tune the
    # router (hedge delay, worker heartbeat period, staleness bound).
    "F16_FLEET_WORKER": ("str", None),
    "F16_FLEET_HEDGE_MS": ("float", 0.0),
    "F16_FLEET_HEARTBEAT_S": ("float", 0.0),
    "F16_FLEET_STALL_S": ("float", 0.0),
    # The audit's device budget (MB): when set, an entry whose measured
    # peak exceeds it is an I401 finding (analysis/rules_ir.run_audit).
    "F16_DEVICE_BUDGET_MB": ("float", 0.0),
}

# The PAPER's grid size — historical reference only. The pre-flight's
# default expectation is derived from config.iter_config_keys() (see
# default_grid_size), so growing the grid needs no edit here; tests that
# want the paper's exact grid pass expected_size=216.
PAPER_GRID_SIZE = 216


def default_grid_size():
    """The config count the package's own enumeration yields — what the
    planner and the sweep iterate. Deriving the
    G101 expectation from it (instead of pinning 216) turns the check
    into axes-vs-enumeration consistency."""
    from flake16_framework_tpu_torch import config as cfg

    return len(list(cfg.iter_config_keys()))


def _finding(rule_id, message, path="flake16_framework_tpu_torch/config.py",
             line=0):
    return Finding(rule_id, RULES[rule_id].severity, path, line, 0,
                   message, snippet=message)


def _dispatch_arity(path, func, param):
    """The count of distinct code constants that ``func`` compares its
    ``param`` with (``==``, ``!=``, ``in``, ``not in``; names or
    attributes), by AST — the *implemented* kernel count the config axis
    must match. None when the file or function is missing or compares
    nothing."""
    try:
        with open(path, encoding="utf-8") as fd:
            tree = ast.parse(fd.read())
    except (OSError, SyntaxError):
        return None
    names = set()
    for fn in ast.walk(tree):
        if not (isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                and fn.name == func):
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Compare)
                    and isinstance(node.left, ast.Name)
                    and node.left.id == param
                    and all(isinstance(op, (ast.Eq, ast.NotEq, ast.In,
                                            ast.NotIn))
                            for op in node.ops)):
                continue
            for comp in node.comparators:
                elts = comp.elts if isinstance(
                    comp, (ast.Tuple, ast.List, ast.Set)) else [comp]
                for e in elts:
                    if isinstance(e, ast.Name):
                        names.add(e.id)
                    elif isinstance(e, ast.Attribute):
                        names.add(e.attr)
    return len(names) or None


def default_switch_arities():
    """The implemented kernel counts, read off the ops sources."""
    ops = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ops")
    return {
        "preprocessing": _dispatch_arity(
            os.path.join(ops, "preprocess.py"), "fit_preprocess",
            "prep_code"),
        "balancing": _dispatch_arity(
            os.path.join(ops, "resample.py"), "resample", "bal_code"),
    }


def preflight_grid(axes=None, *, n_features=None, expected_size=None,
                   switch_arities=None):
    """Validate a candidate grid (default: the real config.GRID_AXES)
    against the kernel registry. Returns a list of Findings — empty means
    the grid is launchable. Pure host-side; never imports torch."""
    if axes is None:
        from flake16_framework_tpu_torch import config as cfg

        axes = cfg.GRID_AXES
        expected_size = (default_grid_size() if expected_size is None
                         else expected_size)
    if n_features is None:
        from flake16_framework_tpu_torch.constants import N_FEATURES

        n_features = N_FEATURES
    if switch_arities is None:
        switch_arities = default_switch_arities()

    findings = []

    # G101: shape of the grid itself.
    if len(axes) != 5:
        findings.append(_finding(
            "G101", f"grid has {len(axes)} axes, want 5 "
            "(flaky, feature-set, preprocessing, balancing, model)"))
        return findings
    names = ("flaky", "feature-set", "preprocessing", "balancing", "model")
    size = 1
    for name, axis in zip(names, axes):
        if not isinstance(axis, dict) or not axis:
            findings.append(_finding(
                "G101", f"{name} axis is not a non-empty dict"))
            return findings
        size *= len(axis)
    if expected_size is not None and size != expected_size:
        findings.append(_finding(
            "G101", f"grid multiplies out to {size} configs, "
            f"want {expected_size}"))

    flaky, feature_sets, preps, bals, models = axes

    # G102: switch-indexed axes must be exactly range(len(axis)).
    for name, axis in (("preprocessing", preps), ("balancing", bals)):
        codes = sorted(v for v in axis.values() if isinstance(v, int))
        if len(codes) != len(axis) or codes != list(range(len(axis))):
            findings.append(_finding(
                "G102", f"{name} codes {sorted(axis.values())!r} are not "
                f"exactly range({len(axis)}) — the dispatcher would raise "
                "or run the wrong kernel"))
        arity = switch_arities.get(name)
        if arity is not None and arity != len(axis):
            findings.append(_finding(
                "G102", f"{name} axis has {len(axis)} settings but the "
                f"implemented dispatcher has {arity} kernels"))
    for name, label in flaky.items():
        if not isinstance(label, int):
            findings.append(_finding(
                "G102", f"flaky type {name!r} label {label!r} is not an "
                "int class label"))

    # G102/G103: every model resolves to a fit-able static spec.
    for name, spec in models.items():
        n_trees = getattr(spec, "n_trees", None)
        if not isinstance(n_trees, int) or n_trees < 1:
            findings.append(_finding(
                "G102", f"model {name!r} has no positive int n_trees "
                f"({n_trees!r}) — no fit path exists for it"))
        try:
            hash(spec)
        except TypeError:
            findings.append(_finding(
                "G103", f"model spec {name!r} is unhashable — it keys the "
                "per-family caches of the sweep and the planner"))

    # G103/G104: feature sets are hashable tuples of in-range columns.
    for name, cols in feature_sets.items():
        try:
            hash(cols)
        except TypeError:
            findings.append(_finding(
                "G103", f"feature set {name!r} columns are unhashable "
                f"({type(cols).__name__}) — must be a tuple"))
        cols_list = list(cols)
        if not cols_list:
            findings.append(_finding(
                "G104", f"feature set {name!r} is empty"))
            continue
        bad = [c for c in cols_list
               if not isinstance(c, int) or not 0 <= c < n_features]
        if bad:
            findings.append(_finding(
                "G104", f"feature set {name!r} columns {bad!r} outside "
                f"range({n_features})"))
        if len(set(cols_list)) != len(cols_list):
            findings.append(_finding(
                "G104", f"feature set {name!r} has duplicate columns"))
    return findings


def _knob_reads(mod):
    """(knob, lineno) for every literal ``F16_*`` environment read in a
    module: ``<env>.get/setdefault/pop("F16_X", ...)`` and
    ``<env>["F16_X"]`` forms (the resilience policies take an injected
    ``environ`` mapping, so ANY receiver counts, not just ``os.environ``
    — a knob string is the census key either way). A name bound to a
    knob literal (``ENV_VAR = "F16_FAULT_INJECT"``) counts as that
    knob's read site: the binding exists to be .get()-ed."""
    out = []
    for node in ast.walk(mod.tree):
        const = None
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
                and node.value.value.startswith("F16_")):
            const = node.value
        elif (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("get", "setdefault", "pop")
                and node.args):
            const = node.args[0]
        elif isinstance(node, ast.Subscript):
            const = node.slice
        if (isinstance(const, ast.Constant)
                and isinstance(const.value, str)
                and const.value.startswith("F16_")):
            out.append((const.value, node.lineno))
    return out


def _knob_value_ok(kind, detail, raw):
    if kind == "enum":
        return raw in detail
    if kind in ("int", "float"):
        try:
            val = int(raw) if kind == "int" else float(raw)
        except ValueError:
            return False
        lo, hi = detail if isinstance(detail, tuple) else (detail, None)
        return val >= lo and (hi is None or val <= hi)
    return True


def preflight_knob_values(environ=None):
    """Validate every SET registry knob's value in ``environ`` (default
    the real environment) — the grower-knob pre-flight half of G106.
    Returns Findings; empty means the environment is launchable."""
    env = os.environ if environ is None else environ
    findings = []
    for name, (kind, detail) in sorted(KNOBS.items()):
        raw = env.get(name)
        if raw is None or _knob_value_ok(kind, detail, raw):
            continue
        if kind == "enum":
            want = "|".join(v for v in detail if v)
        elif isinstance(detail, tuple):
            want = f"{kind} in [{detail[0]}, {detail[1]}]"
        else:
            want = f"{kind} >= {detail}"
        findings.append(_finding(
            "G106", f"env knob {name}={raw!r} is invalid (want {want}) — "
            "the run would raise mid-sweep or silently run a wrong arm",
            path="flake16_framework_tpu_torch/analysis/rules_grid.py"))
    return findings


def _is_executor_scope(fn, aliases):
    """True when ``fn`` carries the ``@executor_scope`` marker, under any
    import alias."""
    from flake16_framework_tpu_torch.analysis.rules_torch import _dotted

    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        dotted = _dotted(target, aliases)
        if dotted and (dotted == "executor_scope"
                       or dotted.endswith(".executor_scope")):
            return True
    return False


# G108: name suffixes that mark a module-level integer as a kernel
# tunable — the knob families the tuner's KnobSpace searches (batch and
# chunk widths, block/tile sizes, bin counts, window widths).
_TUNABLE_SUFFIXES = ("BATCH", "CHUNK", "BLK", "TILE", "BINS", "WINDOW",
                     "WIDTH")


def _imports_torch(tree):
    """True when the module imports torch (any form) — the G108 marker
    for 'this file sits on a kernel path' (``_imports_jax`` in the JAX
    package)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "torch" for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "torch":
                return True
    return False


def _registered_knob_envs():
    """The KnobSpace env-name accept-set (the port's perf/tuner.py) — a
    constant whose ``F16_<NAME>`` counterpart is registered there is
    tunable by the tuner and exempt from G108. The tuner module imports
    no torch at load, so this import keeps the pre-flight off the
    device."""
    from flake16_framework_tpu_torch.perf.tuner import registered_env_names

    return registered_env_names()


def check_tunable_constants(mod):
    """G108: module-level ``NAME = <int literal>`` with a tunable suffix
    in a torch-importing module. A bare literal is invisible to the
    autotuner; registered knobs are read via ``os.environ.get("F16_…")``
    (a Call, not a Constant), so the literal form itself is the tell."""
    if mod.tree is None or not _imports_torch(mod.tree):
        return []
    registered = _registered_knob_envs()
    findings = []
    for node in mod.tree.body:
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Constant)
                and type(node.value.value) is int):
            continue
        for target in node.targets:
            if not isinstance(target, ast.Name):
                continue
            name = target.id.lstrip("_")
            if not (name.isupper()
                    and name.split("_")[-1] in _TUNABLE_SUFFIXES):
                continue
            if "F16_" + name in registered:
                continue  # KnobSpace owns it; the literal is a default
            findings.append(Finding(
                "G108", RULES["G108"].severity, normpath(mod.path),
                node.lineno, node.col_offset,
                f"kernel tunable {target.id} = {node.value.value} is a "
                "hardcoded literal with no KnobSpace registration — "
                "register F16_" + name + " in perf/tuner.py KNOBSPACE "
                "and derive the value from its env read so the tuner "
                "can search it (optima move with shape)",
                snippet=target.id))
    return findings


def check_module(mod):
    """G107: per-config Python-loop device dispatch inside executor
    scope. ``@executor_scope`` marks the functions
    whose contract is batched whole-plan dispatch; a ``run_config`` call
    under a ``for``/``while`` in one of them is the per-config
    round-trip anti-pattern this scope exists to exclude.

    G108: hardcoded tunable constants (check_tunable_constants)."""
    from flake16_framework_tpu_torch.analysis.rules_torch import (
        _import_aliases,
    )

    if mod.tree is None:
        return []
    aliases = _import_aliases(mod.tree)
    findings = list(check_tunable_constants(mod))
    seen = set()
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _is_executor_scope(fn, aliases):
            continue
        for loop in ast.walk(fn):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for call in ast.walk(loop):
                if not (isinstance(call, ast.Call)
                        and (call.func.attr if isinstance(
                            call.func, ast.Attribute)
                            else call.func.id if isinstance(
                                call.func, ast.Name) else None)
                        == "run_config"):
                    continue
                site = (call.lineno, call.col_offset)
                if site in seen:  # nested loops re-walk inner calls
                    continue
                seen.add(site)
                findings.append(Finding(
                    "G107", RULES["G107"].severity, normpath(mod.path),
                    call.lineno, call.col_offset,
                    f"run_config called in a loop inside @executor_scope "
                    f"function {fn.name!r} — one device round-trip per "
                    "config is the engine tax the planner deletes; "
                    "dispatch the whole plan (run_plan) or move the "
                    "per-config fallback outside executor scope",
                    snippet="run_config"))
    return findings


def _span_names(mod):
    """(name, lineno) for every literal obs.span("name", ...) in a module."""
    out = []
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "span"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            out.append((node.args[0].value, node.lineno))
    return out


def check_project(modules):
    """Grid pre-flight + span uniqueness + knob census, once per run."""
    findings = list(preflight_grid())
    findings.extend(preflight_knob_values())

    reads = {}
    for mod in modules:
        if ("/tests/" in f"/{mod.path}" or mod.path.startswith("tests/")
                or mod.tree is None):
            continue  # test fixtures may read ad-hoc knobs
        for name, lineno in _knob_reads(mod):
            reads.setdefault(name, []).append((mod.path, lineno))
    for name, sites in sorted(reads.items()):
        if name not in KNOBS:
            path, lineno = sites[0]
            findings.append(Finding(
                "G106", RULES["G106"].severity, normpath(path), lineno, 0,
                f"env knob {name!r} is read here but not declared in the "
                "G106 registry (analysis/rules_grid.py KNOBS) — declare "
                "it with a validator so the pre-flight can vet its value",
                snippet=name))
    # Stale-entry check only when the knob-bearing core is in the linted
    # set (single-file invocations would otherwise flag every entry).
    if any(mod.path.endswith("ops/trees.py") for mod in modules):
        for name in sorted(set(KNOBS) - set(reads)):
            findings.append(_finding(
                "G106", f"registry knob {name!r} is declared but never "
                "read in the package — stale entry (drop it or wire it)",
                path="flake16_framework_tpu_torch/analysis/rules_grid.py"))

    owners = {}
    for mod in modules:
        if "/tests/" in f"/{mod.path}" or mod.path.startswith("tests/"):
            continue  # test fixtures may reuse production span names
        for name, lineno in _span_names(mod):
            owners.setdefault(name, []).append((mod.path, lineno))
    for name, sites in sorted(owners.items()):
        paths = sorted({p for p, _ in sites})
        if len(paths) > 1:
            path, lineno = sites[-1]
            findings.append(Finding(
                "G105", RULES["G105"].severity, normpath(path), lineno, 0,
                f"span name {name!r} declared in {len(paths)} modules "
                f"({', '.join(paths)}) — report would merge their walls",
                snippet=name))
    return findings
