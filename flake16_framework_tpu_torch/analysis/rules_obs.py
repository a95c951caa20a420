"""Rule pack 3 — telemetry schema drift (O-rules), a copy of the JAX
package's ``analysis/rules_obs.py`` against the port's ``obs/schema.py``,
``obs/metrics.py`` ``METRIC_CENSUS`` and ``serve/wire.py``
``WIRE_FIELDS``. Two layers:

- static (check_module): emitters must only speak the declared wire
  schema — an ``obs.event("kind", ...)`` whose literal kind is missing
  from schema.EVENT_FIELDS is drift that would otherwise show only
  after a run produced a bad document (O102); span names follow the
  ``stage.detail`` lowercase convention the report renderer sorts and
  columnizes (O103).
- documents (check_docs / check_paths): validate emitted events.jsonl /
  manifest.json / ``report --json`` / ``lint --json`` captures against
  obs/schema.py (O101). Not part of the default package lint — on-disk
  runs are per-machine state, not source — but reachable via
  ``lint --telemetry PATH``.
"""

import ast
import json
import os
import re

from flake16_framework_tpu_torch.analysis.engine import (
    ERROR, WARNING, Finding, RuleInfo,
)
from flake16_framework_tpu_torch.obs import schema

RULES = {r.id: r for r in (
    RuleInfo("O101", ERROR,
             "emitted telemetry document violates the wire schema"
             " (obs/schema.py)"),
    RuleInfo("O102", ERROR,
             "obs.event() with a kind not declared in schema.EVENT_FIELDS"
             " — undeclared wire-schema drift"),
    RuleInfo("O103", WARNING,
             "span name does not match the lowercase dotted convention"
             " ([a-z0-9_.]+)"),
    RuleInfo("O104", ERROR,
             "event kind emitted in code but absent from"
             " schema.EVENT_FIELDS, or declared there but never emitted"
             " — two-way wire-schema drift"),
    RuleInfo("O105", ERROR,
             "gauge/counter emitted at a call site but unregistered in"
             " the metrics census (obs/metrics.py METRIC_CENSUS) —"
             " invisible to the live exporter"),
    RuleInfo("O106", ERROR,
             "hardcoded perfdb schema-version literal outside"
             " obs/schema.py — rows must stamp schema.PERFDB_SCHEMA, or"
             " a version drift splits the database"),
    RuleInfo("O107", ERROR,
             "fleet wire-frame dict with a field outside the"
             " flake16-fleet-wire-v1 census (serve/wire.py WIRE_FIELDS),"
             " or a census field no wire-speaking module spells —"
             " two-way wire-protocol drift"),
)}

# Kinds whose emitters live OUTSIDE the package lint scope (the default
# ``lint`` paths). The port's schema keeps the JAX package's event kinds
# so that its validators, ``report`` and ``trace`` read the JAX
# package's runs: ``stage`` (the JAX bench's stage records) is emitted by
# the JAX package only. (``cost`` has the port's own emitters, the
# counting passes of ``obs/costs.py`` and the graph captures of
# ``obs/aot.py``.) Without this, the reverse O104 direction would flag
# kinds that are in fact emitted, by the other package.
_EXTERNAL_EMITTERS = frozenset({"stage"})

_SPAN_NAME_RE = re.compile(r"^[a-z0-9_.]+$")

# Any "flake16-perfdb-*" string constant is a perfdb schema-version
# literal; only obs/schema.py may spell one (the O106 census — the same
# single-source-of-truth discipline O104 enforces for event kinds).
_PERFDB_LITERAL_RE = re.compile(r"^flake16-perfdb-")

# Modules that SPEAK the fleet wire protocol (build or parse frames):
# O107's reverse direction scans these — and only these — for census
# field literals, so serve/wire.py's own census definition cannot
# vacuously satisfy itself.
_WIRE_SPEAKERS = ("serve/router.py", "serve/fleet.py")


def check_module(mod):
    findings = []
    in_schema = mod.path.replace(os.sep, "/").endswith("obs/schema.py")
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _PERFDB_LITERAL_RE.match(node.value) \
                and not in_schema:
            findings.append(mod.finding(
                "O106", RULES["O106"].severity, node,
                f"perfdb schema literal {node.value!r} hardcoded here — "
                "import schema.PERFDB_SCHEMA (obs/schema.py) so one "
                "version bump cannot silently split the database"))
        if not isinstance(node, ast.Call):
            continue
        # O105 covers both call forms — obs.gauge("n", ...) and core.py's
        # own bare gauge("n", ...) — mirroring the O104 census discipline.
        fname = node.func.attr if isinstance(node.func, ast.Attribute) \
            else node.func.id if isinstance(node.func, ast.Name) else None
        if fname in ("gauge", "counter_add") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            from flake16_framework_tpu_torch.obs.metrics import METRIC_CENSUS

            name = node.args[0].value
            if name not in METRIC_CENSUS:
                findings.append(mod.finding(
                    "O105", RULES["O105"].severity, node,
                    f"metric {name!r} is emitted here but unregistered "
                    "in obs/metrics.py METRIC_CENSUS — the live "
                    "exporter's census cannot see it"))
        if not isinstance(node.func, ast.Attribute):
            continue
        if node.func.attr == "event" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            kind = node.args[0].value
            if kind not in schema.EVENT_FIELDS:
                findings.append(mod.finding(
                    "O102", RULES["O102"].severity, node,
                    f"event kind {kind!r} is not declared in "
                    f"schema.EVENT_FIELDS (known: "
                    f"{sorted(schema.EVENT_FIELDS)})"))
        elif node.func.attr == "span" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            name = node.args[0].value
            if not _SPAN_NAME_RE.match(name):
                findings.append(mod.finding(
                    "O103", RULES["O103"].severity, node,
                    f"span name {name!r} does not match "
                    f"{_SPAN_NAME_RE.pattern!r}"))
    return findings


def check_project(mods):
    """O104 — the two-way kind/schema consistency sweep, run once over all
    linted modules so the emit census is project-wide.

    Forward: a raw event dict literal (``{"kind": "<literal>", ...}`` —
    the low-level ``_emit``/``append_jsonl`` style that bypasses
    ``obs.event``'s O102 coverage) whose kind is not declared in
    schema.EVENT_FIELDS. ``obs.event()`` call kinds are O102's job and
    only feed the census here, so one drift never fires twice.

    Reverse: a kind declared in schema.EVENT_FIELDS that no linted module
    emits — dead schema that validators keep accepting. Anchored on the
    declaration in obs/schema.py and only checked when that module is in
    the linted set (linting a lone file must not indict the whole
    schema); kinds with known out-of-scope emitters are allowlisted
    (_EXTERNAL_EMITTERS)."""
    emitted = set()
    dict_literals = []  # (mod, kind-value node, kind)
    for mod in mods:
        for node in ast.walk(mod.tree):
            # Census counts both obs.event("k", ...) and core.py's own
            # bare event("k", ...) calls.
            if isinstance(node, ast.Call) \
                    and ((isinstance(node.func, ast.Attribute)
                          and node.func.attr == "event")
                         or (isinstance(node.func, ast.Name)
                             and node.func.id == "event")) \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                emitted.add(node.args[0].value)
            elif isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) and k.value == "kind" \
                            and isinstance(v, ast.Constant) \
                            and isinstance(v.value, str):
                        emitted.add(v.value)
                        dict_literals.append((mod, v, v.value))

    findings = []
    for mod, node, kind in dict_literals:
        if kind not in schema.EVENT_FIELDS:
            findings.append(mod.finding(
                "O104", RULES["O104"].severity, node,
                f"event dict literal with kind {kind!r} not declared in "
                f"schema.EVENT_FIELDS (known: "
                f"{sorted(schema.EVENT_FIELDS)})"))

    schema_mod = next(
        (m for m in mods
         if m.path.replace(os.sep, "/").endswith("obs/schema.py")), None)
    if schema_mod is not None:
        for kind in sorted(set(schema.EVENT_FIELDS) - emitted
                           - _EXTERNAL_EMITTERS):
            node = _event_fields_key_node(schema_mod.tree, kind)
            if node is None:
                continue
            findings.append(schema_mod.finding(
                "O104", RULES["O104"].severity, node,
                f"event kind {kind!r} is declared in schema.EVENT_FIELDS "
                "but no linted module emits it"))
    findings += _check_wire_census(mods)
    return findings


def _load_wire_fields():
    """serve/wire.py's WIRE_FIELDS census, loaded WITHOUT executing the
    serve package __init__ (which pulls the whole serving stack and
    torch — the lint path must stay device-free). Returns None when the
    module cannot load (the rule then stays silent rather than crashing
    the lint)."""
    import sys

    mod = sys.modules.get("flake16_framework_tpu_torch.serve.wire")
    if mod is None:
        import importlib.util

        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "serve", "wire.py")
        try:
            spec = importlib.util.spec_from_file_location(
                "_f16_wire_census", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except Exception:
            return None
    return getattr(mod, "WIRE_FIELDS", None)


def _wire_frame_kind(node):
    """Which flake16-fleet-wire-v1 frame a dict literal spells, by its
    discriminating keys — request (``id`` + ``op``), response (``id`` +
    ``ok``), push (sole key ``hb``) — or None for an ordinary dict."""
    keys = {k.value for k in node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}
    if {"id", "op"} <= keys:
        return "request"
    if {"id", "ok"} <= keys:
        return "response"
    if keys == {"hb"}:
        return "push"
    return None


def _check_wire_census(mods):
    """O107 — the wire-field census sweep, O104's discipline applied to
    the fleet wire protocol (the trace-context fields ride score frames,
    so emitters/parsers and the census in serve/wire.py must not
    drift).

    Forward: any dict literal recognizable as a wire frame (see
    ``_wire_frame_kind``) whose string keys include a field absent from
    that frame's census entry — a frame the other end of the socket will
    silently drop fields from. Reverse: a census field that no
    wire-speaking module (_WIRE_SPEAKERS) spells as a string literal —
    dead protocol the census keeps promising; anchored on the census in
    serve/wire.py and only checked when every speaker is in the linted
    set (linting a lone file must not indict the protocol)."""
    wire_fields = _load_wire_fields()
    if not wire_fields:
        return []
    findings = []
    spoken = set()
    speakers = set()
    wire_mod = None
    for mod in mods:
        path = mod.path.replace(os.sep, "/")
        if path.endswith("serve/wire.py"):
            wire_mod = mod
        is_speaker = path.endswith(_WIRE_SPEAKERS)
        if is_speaker:
            speakers.add(os.path.basename(path))
        for node in ast.walk(mod.tree):
            if is_speaker and isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                spoken.add(node.value)
            if not isinstance(node, ast.Dict):
                continue
            frame = _wire_frame_kind(node)
            if frame is None:
                continue
            allowed = wire_fields[frame]
            for k in node.keys:
                if isinstance(k, ast.Constant) \
                        and isinstance(k.value, str) \
                        and k.value not in allowed:
                    findings.append(mod.finding(
                        "O107", RULES["O107"].severity, k,
                        f"{frame} frame field {k.value!r} is not in the "
                        "flake16-fleet-wire-v1 census (serve/wire.py "
                        f"WIRE_FIELDS[{frame!r}]: {sorted(allowed)})"))

    if wire_mod is not None and len(speakers) == len(_WIRE_SPEAKERS):
        every = set().union(*wire_fields.values())
        for field in sorted(every - spoken):
            node = _first_constant_node(wire_mod.tree, field)
            if node is None:
                continue
            findings.append(wire_mod.finding(
                "O107", RULES["O107"].severity, node,
                f"wire field {field!r} is declared in WIRE_FIELDS but "
                "no wire-speaking module "
                f"({', '.join(sorted(speakers))}) spells it"))
    return findings


def _first_constant_node(tree, value):
    """The first string-constant node equal to ``value`` (the reverse
    O107 finding's anchor inside serve/wire.py's census)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and node.value == value:
            return node
    return None


def _event_fields_key_node(tree, kind):
    """The dict-key node declaring ``kind`` inside schema.py's
    EVENT_FIELDS literal (the reverse-drift finding's anchor)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "EVENT_FIELDS"
                        for t in node.targets) \
                and isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and k.value == kind:
                    return k
    return None


# -- emitted-document validation (the old tool's body) ------------------


def check_events_file(path):
    """(n_events, problems) for one events.jsonl file."""
    problems = []
    n = 0
    with open(path) as fd:
        for lineno, line in enumerate(fd, start=1):
            if not line.strip():
                continue
            n += 1
            try:
                ev = json.loads(line)
            except ValueError as e:
                problems.append(f"{path}:{lineno}: not JSON ({e})")
                continue
            problems += [f"{path}:{lineno}: {p}"
                         for p in schema.validate_event(ev)]
    return n, problems


def check_json_file(path):
    """Problems for one JSON document — a manifest, a ``report --json``
    capture, or a ``lint --json`` capture, dispatched on its ``schema``."""
    try:
        with open(path) as fd:
            obj = json.load(fd)
    except ValueError as e:
        return [f"{path}: not JSON ({e})"]
    if isinstance(obj, dict) and obj.get("schema") == schema.REPORT_SCHEMA:
        probs = schema.validate_report(obj)
    elif isinstance(obj, dict) and obj.get("schema") == schema.LINT_SCHEMA:
        probs = schema.validate_lint_report(obj)
    else:
        probs = schema.validate_manifest(obj)
    return [f"{path}: {p}" for p in probs]


def check_run_dir(path):
    problems = []
    n_events = 0
    events = os.path.join(path, schema.EVENTS_FILE)
    manifest = os.path.join(path, schema.MANIFEST_FILE)
    if os.path.isfile(events):
        n_events, probs = check_events_file(events)
        problems += probs
    else:
        problems.append(f"{path}: no {schema.EVENTS_FILE}")
    if os.path.isfile(manifest):
        problems += check_json_file(manifest)
    else:
        problems.append(f"{path}: no {schema.MANIFEST_FILE}")
    return n_events, problems


def check_paths(paths):
    """(n_events_validated, problems) across files and run directories —
    the JAX package's ``check_paths`` contract."""
    n_total, problems = 0, []
    for path in paths:
        if os.path.isdir(path):
            n, probs = check_run_dir(path)
            n_total += n
            problems += probs
        elif path.endswith(".jsonl"):
            n, probs = check_events_file(path)
            n_total += n
            problems += probs
        else:
            problems += check_json_file(path)
    return n_total, problems


def check_docs(paths):
    """Document problems as O101 findings (the ``lint --telemetry PATH``
    path). Each problem string already carries its own path context."""
    _, problems = check_paths(paths)
    return [Finding("O101", RULES["O101"].severity, str(p).split(":")[0],
                    0, 0, p, snippet=p)
            for p in problems]
