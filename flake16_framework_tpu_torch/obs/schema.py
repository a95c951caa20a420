"""The telemetry wire schema: the event half and the report half of the
JAX package's ``obs/schema.py``, copied, so that an ``events.jsonl``,
``manifest.json`` or ``report --json`` document this package writes
validates in either package.

Three documents exist per run:

- ``events.jsonl`` — one JSON object per line, ``kind`` in EVENT_FIELDS.
  Every event carries ``ts`` (unix seconds) and ``run`` (the run token).
- ``manifest.json`` — one object identifying the run (schema
  MANIFEST_SCHEMA): run token, start time, argv, python, env fingerprint,
  enriched as facts become known (verb, device backend and kind).
- ``report --json`` output — schema REPORT_SCHEMA, derived from the two
  above by ``obs/report.summarize``.

Validation is permissive on EXTRA fields (events may carry arbitrary
context like config keys) and strict on required fields and their types.
Three more documents share the family: the performance database's rows
(PERFDB_SCHEMA, ``obs/perfdb.py``), the lock-order witness's dump
(LOCKWATCH_SCHEMA, ``obs/lockwatch.py``) and the ``lint --json`` report
(LINT_SCHEMA, ``analysis/engine.py``), and so does the ``audit --json``
report (AUDIT_SCHEMA, ``analysis/cli.audit_report``): the port's audit
document adds ``backend`` and, on each envelope, the hist window
``width``, so it validates under the JAX package's validator, and a JAX
package's audit document validates under this one.
"""

EVENTS_FILE = "events.jsonl"
MANIFEST_FILE = "manifest.json"

TELEMETRY_SCHEMA = "flake16-telemetry-v1"
MANIFEST_SCHEMA = "flake16-run-manifest-v1"
REPORT_SCHEMA = "flake16-report-v1"
# The ``lint --json`` document (analysis/engine.LintResult.to_report) — a
# member of this same schema family so the drift lint validates its own
# reports (analysis/rules_obs.check_json_file).
LINT_SCHEMA = "flake16-lint-report-v1"
# The ``audit --json`` document of either package, which the performance
# database ingests (its memory envelopes; obs/perfdb.rows_from_audit).
AUDIT_SCHEMA = "flake16-audit-report-v1"
# The performance-database row (obs/perfdb.py): one CRC'd JSONL line per
# (backend, shape-signature, kernel/stage, knob-snapshot digest)
# observation; rows stamp this constant.
PERFDB_SCHEMA = "flake16-perfdb-v1"
# The lock-order witness's document (obs/lockwatch.py): lock creation
# sites and the observed held->acquired order edges, written at exit
# when F16_LOCKWATCH is armed.
LOCKWATCH_SCHEMA = "flake16-lockwatch-v1"

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
    # Performance-database lifecycle (obs/perfdb.py): ``action`` is
    # append | truncate | backfill. Append carries ``n`` (rows written)
    # and ``path``; truncate carries the byte ``offset`` of the torn
    # tail it cut; backfill carries ``n``/``rounds``.
    "perf": {"action": str},
}

MANIFEST_FIELDS = {
    "schema": str, "run": str, "started_ts": _NUM, "argv": list,
    "python": str, "env": dict,
}

REPORT_FIELDS = {
    "schema": str, "run": str, "wall_s": _NUM, "spans": dict,
    "counters": dict, "gauges": dict, "faults": dict,
}

# Required numeric per-span stats in a report's ``spans`` values.
REPORT_SPAN_FIELDS = {"n", "cold_n", "total_s", "compile_est_s", "execute_s"}

LINT_FIELDS = {"schema": str, "findings": list, "counts": dict,
               "rules": dict}
AUDIT_FIELDS = {"schema": str, "findings": list, "counts": dict,
                "census": dict, "envelopes": list, "entries": list}
AUDIT_CENSUS_FIELDS = ("static", "runtime", "match")
AUDIT_ENVELOPE_FIELDS = ("entry", "arg_bytes", "out_bytes", "peak_bytes",
                         "peak_mb")
LINT_FINDING_FIELDS = {"rule": str, "severity": str, "path": str,
                       "line": int, "col": int, "message": str}
LINT_COUNT_FIELDS = ("errors", "warnings", "suppressed_inline",
                     "suppressed_baseline", "files")


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


def validate_lint_report(obj):
    """Problems with one ``lint --json`` document (empty list = valid)."""
    problems = []
    if not isinstance(obj, dict):
        return [f"lint report is {type(obj).__name__}, want object"]
    _check_fields(obj, LINT_FIELDS, problems, "lint report")
    if obj.get("schema") != LINT_SCHEMA:
        problems.append(
            f"lint report: schema {obj.get('schema')!r} != {LINT_SCHEMA!r}")
    for i, f in enumerate(obj.get("findings") or ()):
        if not isinstance(f, dict):
            problems.append(f"lint report: findings[{i}] is not an object")
            continue
        _check_fields(f, LINT_FINDING_FIELDS, problems,
                      f"lint report: findings[{i}]")
    counts = obj.get("counts")
    if isinstance(counts, dict):
        for name in LINT_COUNT_FIELDS:
            if not isinstance(counts.get(name), int):
                problems.append(
                    f"lint report: counts[{name!r}] missing or not int")
    return problems


def validate_audit_report(obj):
    """Problems with one ``audit --json`` document (empty list = valid)."""
    problems = []
    if not isinstance(obj, dict):
        return [f"audit report is {type(obj).__name__}, want object"]
    _check_fields(obj, AUDIT_FIELDS, problems, "audit report")
    if obj.get("schema") != AUDIT_SCHEMA:
        problems.append(
            f"audit report: schema {obj.get('schema')!r} != "
            f"{AUDIT_SCHEMA!r}")
    for i, f in enumerate(obj.get("findings") or ()):
        if not isinstance(f, dict):
            problems.append(f"audit report: findings[{i}] is not an object")
            continue
        _check_fields(f, LINT_FINDING_FIELDS, problems,
                      f"audit report: findings[{i}]")
    census = obj.get("census")
    if isinstance(census, dict):
        for name in AUDIT_CENSUS_FIELDS:
            if name not in census:
                problems.append(
                    f"audit report: census missing {name!r}")
    for i, env in enumerate(obj.get("envelopes") or ()):
        if not isinstance(env, dict):
            problems.append(
                f"audit report: envelopes[{i}] is not an object")
            continue
        missing = set(AUDIT_ENVELOPE_FIELDS) - set(env)
        if missing:
            problems.append(
                f"audit report: envelopes[{i}] missing {sorted(missing)}")
    return problems


# One perf-database row (obs/perfdb.py). The key quadruple is
# (backend, shape, kernel, ksig): ``shape`` is the shape-signature
# string, ``kernel`` names the kernel/stage the metrics time, ``ksig``
# digests the knob snapshot (``"null"`` when ``knobs`` is null).
# ``metrics`` maps metric name -> number; ``crc`` seals the row.
PERFDB_ROW_FIELDS = {"schema": str, "backend": str, "shape": str,
                     "kernel": str, "ksig": str, "metrics": dict,
                     "src": str, "crc": str}


def validate_perfdb_row(obj):
    """Problems with one perfdb JSONL row (empty list = valid). CRC
    verification is the store's job (obs/perfdb.load): this checks the
    declared shape only, so torn-tail recovery stays a storage concern."""
    problems = []
    if not isinstance(obj, dict):
        return [f"perfdb row is {type(obj).__name__}, want object"]
    _check_fields(obj, PERFDB_ROW_FIELDS, problems, "perfdb row")
    if obj.get("schema") != PERFDB_SCHEMA:
        problems.append(
            f"perfdb row: schema {obj.get('schema')!r} != "
            f"{PERFDB_SCHEMA!r}")
    knobs = obj.get("knobs")
    if knobs is not None and not isinstance(knobs, dict):
        problems.append(
            f"perfdb row: field 'knobs' has type "
            f"{type(knobs).__name__}, want dict or null")
    for name, v in (obj.get("metrics") or {}).items():
        if not isinstance(v, _NUM):
            problems.append(
                f"perfdb row: metrics[{name!r}] is not numeric")
    return problems


def validate_report(obj):
    problems = []
    if not isinstance(obj, dict):
        return [f"report is {type(obj).__name__}, want object"]
    _check_fields(obj, REPORT_FIELDS, problems, "report")
    if obj.get("schema") != REPORT_SCHEMA:
        problems.append(
            f"report: schema {obj.get('schema')!r} != {REPORT_SCHEMA!r}")
    for name, stats in (obj.get("spans") or {}).items():
        if not isinstance(stats, dict):
            problems.append(f"report: spans[{name!r}] is not an object")
            continue
        missing = REPORT_SPAN_FIELDS - set(stats)
        if missing:
            problems.append(
                f"report: spans[{name!r}] missing {sorted(missing)}")
    return problems
