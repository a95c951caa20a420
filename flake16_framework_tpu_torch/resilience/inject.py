"""The fault-injection harness (a copy of the JAX package's, with the
same grammar, so one plan string means the same in both packages):
deterministic faults on the CPU, so that every resilience path runs in the
tests without a faulting device. ``F16_FAULT_INJECT`` holds a plan of
``;``-separated entries:

    <config>:<attempt>:<class>

- ``config`` — the config's index in the canonical 216-config order
  (``config.iter_config_keys()``; the same index that seeds the config's
  keys), or ``*`` for every config.
- ``attempt`` — the 1-based dispatch attempt to fail, or ``*`` to fail
  every attempt (exhausts retries -> quarantine).
- ``class`` — a fault class from faults.FAULT_CLASSES, or a short alias:
  transient, oom, deterministic, envelope, relay.

Examples:

    F16_FAULT_INJECT="3:1:transient"        # config 3 faults once, retries
    F16_FAULT_INJECT="5:1:oom;7:*:transient"  # 5 retries, 7 quarantines

The guard consults the plan BEFORE each dispatch attempt, so an injected
fault takes the exact classify/retry path a real device fault would.

PROCESS classes, ``sigkill`` and ``sigterm``, drive the kill drill
(resilience/supervisor.py). A process entry reads

    <config>:<fold>:sigkill

where the second field is the 1-based FOLD whose journal append triggers
the signal: the write-ahead journal (resilience/journal.py) delivers the
signal to its own process immediately AFTER fsyncing that fold's record,
so the record is durable and everything after it is lost. Process entries
are invisible to the dispatch guard (``check`` skips them), and the
supervisor strips them from the child environment on restart, so each
injected kill fires exactly once.

The fleet WORKER classes ``worker-kill`` and ``worker-stall`` read

    <worker>:<request#>:worker-kill

where the first field is the worker's index in its fleet and the second
the 1-based score request whose arrival triggers the fault
(``serve/fleet.py``): ``worker-kill`` SIGKILLs the worker with its
requests in flight, ``worker-stall`` freezes it (no heartbeats, accepted
requests never answered). ``check`` and ``process_signal`` skip them, and
the supervisor and the fleet manager strip them from a restarted child's
environment.
"""

import os
import signal as _signal

from flake16_framework_tpu_torch.resilience import faults

ENV_VAR = "F16_FAULT_INJECT"

# Process-level classes (chaos harness): delivered as real signals by the
# journal at fold-append points, not raised as InjectedFault by the guard.
PROCESS_CLASSES = {
    "sigkill": _signal.SIGKILL,
    "sigterm": _signal.SIGTERM,
}

# Fleet worker classes (<worker>:<request#>:worker-kill): delivered by the
# fleet worker as a score request arrives, skipped by ``check`` and
# ``process_signal``, stripped on a restart.
WORKER_CLASSES = ("worker-kill", "worker-stall")

_CLASS_ALIASES = {
    "transient": faults.TRANSIENT_DEVICE,
    "oom": faults.OOM,
    "deterministic": faults.DETERMINISTIC,
    "envelope": faults.ENVELOPE_OVERRUN,
    "relay": faults.RELAY_DOWN,
}
_CLASS_ALIASES.update({c: c for c in faults.FAULT_CLASSES})


class InjectedFault(RuntimeError):
    """A plan-scheduled fault. Carries ``fault_class`` so faults.classify
    routes it exactly like the real thing."""

    def __init__(self, message, fault_class):
        super().__init__(message)
        self.fault_class = fault_class


class FaultPlan:
    """A parsed injection plan: entries of (config_index, attempt, class),
    None meaning wildcard for the first two."""

    def __init__(self, entries):
        self.entries = tuple(entries)

    def __bool__(self):
        return bool(self.entries)

    def check(self, config_index, attempt):
        """Raise InjectedFault when the plan schedules a fault for this
        (config, attempt) dispatch; no-op otherwise. Process entries
        (sigkill/sigterm) are NOT the guard's to deliver — they belong to
        the journal's fold-append points — and worker entries belong to
        the fleet worker, so both are skipped here."""
        for k, j, fc in self.entries:
            if fc in PROCESS_CLASSES or fc in WORKER_CLASSES:
                continue
            if (k is None or k == config_index) and \
                    (j is None or j == attempt):
                raise InjectedFault(
                    f"injected {fc} fault "
                    f"(config {config_index}, attempt {attempt})", fc)

    def process_entries(self):
        """The (config_index, fold_1based, class_name) process entries —
        the chaos-harness subset of the plan."""
        return tuple((k, j, fc) for k, j, fc in self.entries
                     if fc in PROCESS_CLASSES)

    def process_signal(self, config_index, fold):
        """The signal number scheduled for this (config, 1-based fold)
        journal append, or None. Consulted by SweepJournal.record_fold
        AFTER the record is fsync'd."""
        for k, j, fc in self.process_entries():
            if (k is None or k == config_index) and \
                    (j is None or j == fold):
                return PROCESS_CLASSES[fc]
        return None

    def worker_entries(self):
        """The (worker_index, request_1based, class_name) fleet-worker
        entries — the fleet chaos subset of the plan."""
        return tuple((k, j, fc) for k, j, fc in self.entries
                     if fc in WORKER_CLASSES)

    def worker_action(self, worker_index, request_no):
        """The worker fault class ("worker-kill"/"worker-stall")
        scheduled for this worker's 1-based ``request_no`` score request,
        or None. Consulted by the fleet worker BEFORE it submits the
        request to its service."""
        for k, j, fc in self.worker_entries():
            if (k is None or k == worker_index) and \
                    (j is None or j == request_no):
                return fc
        return None


def parse_plan(spec):
    """Parse an F16_FAULT_INJECT value; raises ValueError on bad grammar
    (a typo'd plan silently injecting nothing would defeat the harness)."""
    entries = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"{ENV_VAR} entry {raw!r}: want <config>:<attempt>:<class>")
        k_s, j_s, fc_s = (p.strip() for p in parts)
        try:
            k = None if k_s == "*" else int(k_s)
            j = None if j_s == "*" else int(j_s)
        except ValueError:
            raise ValueError(
                f"{ENV_VAR} entry {raw!r}: config/attempt must be an "
                f"integer or '*'") from None
        if j is not None and j < 1:
            raise ValueError(
                f"{ENV_VAR} entry {raw!r}: attempts/folds are 1-based")
        if fc_s in PROCESS_CLASSES or fc_s in WORKER_CLASSES:
            fc = fc_s
        else:
            fc = _CLASS_ALIASES.get(fc_s)
        if fc is None:
            known = sorted(set(_CLASS_ALIASES) | set(PROCESS_CLASSES)
                           | set(WORKER_CLASSES))
            raise ValueError(
                f"{ENV_VAR} entry {raw!r}: unknown fault class {fc_s!r} "
                f"(want one of {known})")
        entries.append((k, j, fc))
    return FaultPlan(entries)


def strip_process_entries(spec):
    """``spec`` minus its process (sigkill/sigterm) AND fleet worker
    (worker-kill/worker-stall) entries — what the supervisor and the
    fleet manager export to a restarted child so an injected fault fires
    exactly once. Returns ""
    when nothing survives."""
    kept = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = [p.strip() for p in raw.split(":")]
        if len(parts) == 3 and (parts[2] in PROCESS_CLASSES
                                or parts[2] in WORKER_CLASSES):
            continue
        kept.append(raw)
    return ";".join(kept)


def plan_from_env(environ=None):
    """The active plan from F16_FAULT_INJECT, or None when unset/empty."""
    spec = (environ if environ is not None else os.environ).get(ENV_VAR, "")
    if not spec.strip():
        return None
    return parse_plan(spec)
