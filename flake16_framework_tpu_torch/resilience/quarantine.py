"""Per-config quarantine: the ledger sidecar and the nonzero exit (a copy
of the JAX package's; the sidecars read the same).

A config that exhausts the dispatch guard's retries must not abort the
rest of the sweep: the sweep records it — fault class plus full attempt
history — in ``<scores.pkl>.quarantine.json`` beside the pickle and keeps
going. The scores pickle itself NEVER holds quarantine markers: its
values keep the exact 4-element reference schema, so a quarantined config
is simply ABSENT, and the per-config resume re-attempts exactly the
quarantined configs on the next run. A re-attempt that completes clears
the sidecar entry.

``write_scores`` finishes the sweep, persists everything, then raises
``QuarantinedConfigs`` (a SystemExit with code QUARANTINE_EXIT_CODE) so
``python -m flake16_framework_tpu_torch scores`` exits nonzero listing
only the quarantined configs — partial success is visible to CI without
being mistaken for a clean run.
"""

import json
import os

from flake16_framework_tpu_torch.utils.atomic import atomic_write_bytes

SIDECAR_SCHEMA = "flake16-quarantine-v1"
# "The sweep finished but quarantined configs remain" is its own,
# scriptable condition.
QUARANTINE_EXIT_CODE = 23


def sidecar_path(out_file):
    return str(out_file) + ".quarantine.json"


def load_sidecar(path):
    """{config_keys_tuple: {"fault_class": ..., "attempts": [...]}} from a
    sidecar; {} when absent or unreadable (the sidecar is a record, not a
    gate — a torn write must not block a resume)."""
    try:
        with open(path) as fd:
            doc = json.load(fd)
    except (OSError, ValueError):
        return {}
    entries = {}
    for rec in doc.get("configs", ()):
        try:
            keys = tuple(rec["config"])
        except (TypeError, KeyError):
            continue
        entries[keys] = {"fault_class": rec.get("fault_class", "?"),
                         "attempts": list(rec.get("attempts", ()))}
    return entries


def save_sidecar(path, entries):
    """Atomic, fsync'd write, like the pickle it sits beside."""
    doc = {
        "schema": SIDECAR_SCHEMA,
        "note": ("configs quarantined by the resilience layer: each "
                 "exhausted the dispatch guard's retries (attempt history "
                 "below) and is ABSENT from the scores pickle, so a "
                 "resumed run re-attempts exactly these"),
        "configs": [
            {"config": list(keys), "fault_class": e.get("fault_class", "?"),
             "attempts": list(e.get("attempts", ()))}
            for keys, e in sorted(entries.items())
        ],
    }
    atomic_write_bytes(path, json.dumps(doc, indent=1).encode())


def update_sidecar(path, quarantined, completed=()):
    """Merge this run's quarantine set into the sidecar: entries for
    configs now completed are cleared, fresh entries win over stale ones.
    Returns the merged dict. The file is (re)written whenever there is
    anything to record or clear."""
    prev = load_sidecar(path)
    done = {tuple(k) for k in completed}
    merged = {k: v for k, v in prev.items() if k not in done}
    merged.update({tuple(k): v for k, v in quarantined.items()})
    if merged or prev or os.path.exists(path):
        save_sidecar(path, merged)
    return merged


class QuarantinedConfigs(SystemExit):
    """Raised by write_scores AFTER the sweep completed and every artifact
    is on disk: carries the quarantine dict (and the scores produced) and
    exits with QUARANTINE_EXIT_CODE under the CLI."""

    def __init__(self, quarantined, scores=None):
        super().__init__(QUARANTINE_EXIT_CODE)
        self.quarantined = dict(quarantined)
        self.scores = scores

    def __str__(self):
        names = ", ".join("/".join(k) for k in sorted(self.quarantined))
        return (f"{len(self.quarantined)} config(s) quarantined "
                f"(exit {QUARANTINE_EXIT_CODE}): {names}")
