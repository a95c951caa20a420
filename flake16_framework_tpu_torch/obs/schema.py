"""The telemetry wire schema, event half (a copy of the JAX package's
``obs/schema.py``, so that an ``events.jsonl`` or ``manifest.json`` this
package writes validates in either package).

Two documents exist on disk per run:

- ``events.jsonl`` — one JSON object per line, ``kind`` in EVENT_FIELDS.
  Every event carries ``ts`` (unix seconds) and ``run`` (the run token).
- ``manifest.json`` — one object identifying the run (schema
  MANIFEST_SCHEMA): run token, start time, argv, python, env fingerprint,
  enriched as facts become known.

Validation is permissive on EXTRA fields (events may carry arbitrary
context like config keys) and strict on required fields and their types.
The report, lint, audit, perfdb and lockwatch schemas come with the
port's analysis tooling (ROADMAP.md §A 6).
"""

EVENTS_FILE = "events.jsonl"
MANIFEST_FILE = "manifest.json"

TELEMETRY_SCHEMA = "flake16-telemetry-v1"
MANIFEST_SCHEMA = "flake16-run-manifest-v1"

_NUM = (int, float)

# kind -> {field: allowed types}; every event also carries the COMMON set.
COMMON_FIELDS = {"kind": str, "ts": _NUM, "run": str}
EVENT_FIELDS = {
    # A timed region. ``cold`` marks the first occurrence of this span's
    # (name, key) in the process.
    "span": {"name": str, "wall_s": _NUM, "cold": bool},
    # Monotonic totals: inc and post-inc total.
    "counter": {"name": str, "inc": _NUM, "total": _NUM},
    # Point-in-time measurements (peak RSS, device memory, ...).
    "gauge": {"name": str, "value": _NUM},
    # Liveness trail; a dead run's last heartbeat timestamps where it died.
    "heartbeat": {"uptime_s": _NUM, "rss_mb": _NUM},
    # A profiler capture started.
    "profile": {"trace_dir": str},
    # Mirror of a bench stage record.
    "stage": {"stage": str},
    # A resilience-layer transition: ``fault_class`` is one of faults.
    # FAULT_CLASSES; ``action`` is retry | recovered | degrade | abandon |
    # quarantine | ledger-reset; ``attempt`` is the 1-based attempt.
    "fault": {"fault_class": str, "action": str, "attempt": int},
    # One compiled kernel's cost-model charge sheet.
    "cost": {"span": str, "flops": _NUM, "bytes": _NUM, "compile_s": _NUM},
    # Write-ahead journal lifecycle: replay | truncate | reset | finalize.
    "journal": {"action": str},
    # Serve graceful-drain state machine: ``phase`` is begin | complete |
    # abort; complete/abort carry completed/rejected/aborted.
    "drain": {"phase": str},
    # Serving-fleet lifecycle (serve/fleet.py and serve/router.py):
    # ``action`` is restart | budget-exhausted | respawn-drained | failed
    # (manager) or link-down | rolling-drain | rolling-done | hedge |
    # hedge-coalesced | redispatch (router); ``worker`` is the fleet index.
    "fleet": {"action": str, "worker": int},
    # Supervisor child restart: ``attempt`` is the 1-based restart number.
    "restart": {"attempt": int},
    # Metrics-exporter lifecycle: serve | stop.
    "metrics": {"action": str},
    # SLO monitor transition (obs/slo.py): ``state`` is breach |
    # recovered, both with the fast/slow burn rates; a breach carries
    # ``degraded`` (always False in this package: it has no fallback).
    "slo": {"state": str, "burn_fast": _NUM, "burn_slow": _NUM},
    # Flight-recorder lifecycle (obs/flight.py): armed | dump | dump-dir.
    "flight": {"action": str},
    # Performance-observatory lifecycle: append | truncate | backfill.
    "perf": {"action": str},
}

MANIFEST_FIELDS = {
    "schema": str, "run": str, "started_ts": _NUM, "argv": list,
    "python": str, "env": dict,
}


def _check_fields(obj, fields, problems, ctx):
    for name, types in fields.items():
        if name not in obj:
            problems.append(f"{ctx}: missing required field {name!r}")
        elif not isinstance(obj[name], types):
            problems.append(
                f"{ctx}: field {name!r} has type "
                f"{type(obj[name]).__name__}, want {types}")


def validate_event(obj):
    """Problems with one events.jsonl object (empty list = valid)."""
    problems = []
    if not isinstance(obj, dict):
        return [f"event is {type(obj).__name__}, want object"]
    kind = obj.get("kind")
    if kind not in EVENT_FIELDS:
        return [f"unknown event kind {kind!r} "
                f"(known: {sorted(EVENT_FIELDS)})"]
    ctx = f"event kind={kind}"
    _check_fields(obj, COMMON_FIELDS, problems, ctx)
    _check_fields(obj, EVENT_FIELDS[kind], problems, ctx)
    return problems


def validate_manifest(obj):
    problems = []
    if not isinstance(obj, dict):
        return [f"manifest is {type(obj).__name__}, want object"]
    _check_fields(obj, MANIFEST_FIELDS, problems, "manifest")
    if obj.get("schema") not in (None, MANIFEST_SCHEMA):
        problems.append(
            f"manifest: schema {obj.get('schema')!r} != {MANIFEST_SCHEMA!r}")
    return problems
