"""The ``lint`` CLI verb (``__main__.py``), a copy of the JAX package's
``analysis/cli.py`` without its jaxpr half:

    python -m flake16_framework_tpu_torch lint [PATHS...] [--json]
        [--baseline FILE] [--telemetry PATH] [--rules] [--concurrency]

With no PATHS the package itself is linted (the gate invocation; the
package lints clean). ``--json`` prints the ``lint-report-v1`` document
(obs.schema.LINT_SCHEMA — same schema family as telemetry, validated by
the same drift lint). ``--baseline`` subtracts a recorded fingerprint
multiset (``python -m flake16_framework_tpu_torch.analysis.baseline``
writes one). ``--telemetry`` additionally validates emitted telemetry
documents at PATH (repeatable). ``--rules`` prints the rule catalog and
exits 0. ``--concurrency`` restricts the run to the concurrency pack
(C101–C503, rules_conc) — the focused invocation for auditing the
threaded serving substrate.

The JAX package's ``--ir`` (and its ``audit`` verb) walk jaxprs; their
counterpart over ``torch.export`` graphs is not built, so ``--ir`` is
refused with a message (ROADMAP.md §A 7).

Exit status: 0 = no unsuppressed findings, 1 = findings; a usage error
raises ValueError (the convention of the other verbs).
"""

import json
import os
import sys

from flake16_framework_tpu_torch.analysis import engine as eng
from flake16_framework_tpu_torch.analysis import (
    rules_conc, rules_grid, rules_obs, rules_torch,
)

# Every pack runs in every lint — pure AST, dogfooded to zero on the
# package.
PACKS = (rules_torch, rules_grid, rules_obs, rules_conc)

IR_REFUSED = ("lint --ir walks jaxprs in the JAX package; the port's "
              "counterpart over torch.export graphs is not built yet "
              "(ROADMAP.md §A 7)")


def default_paths():
    """The package directory — what the gate lints."""
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def build_engine(packs=None):
    return eng.Engine(PACKS if packs is None else packs)


def run_lint(paths=None, baseline_file=None, telemetry_paths=(),
             packs=None):
    """The LintResult for PATHS, telemetry-document findings folded in.
    ``packs`` restricts the run (the ``--concurrency`` focus flag)."""
    engine = build_engine(packs)
    result = engine.lint(paths or default_paths(),
                         baseline=eng.load_baseline(baseline_file,
                                                    rules=engine.rules))
    if telemetry_paths:
        result.findings.extend(rules_obs.check_docs(telemetry_paths))
    return result


def lint_main(args, out=None):
    out = out or sys.stdout
    as_json = False
    show_rules = False
    conc_only = False
    baseline = None
    telemetry = []
    paths = []
    it = iter(args)
    for a in it:
        if a == "--json":
            as_json = True
        elif a == "--rules":
            show_rules = True
        elif a == "--ir":
            raise ValueError(IR_REFUSED)
        elif a == "--concurrency":
            conc_only = True
        elif a == "--baseline":
            baseline = next(it, None)
            if baseline is None:
                raise ValueError("--baseline needs a file argument")
        elif a == "--telemetry":
            t = next(it, None)
            if t is None:
                raise ValueError("--telemetry needs a path argument")
            telemetry.append(t)
        elif a.startswith("--"):
            raise ValueError(f"Unrecognized lint option {a!r}")
        else:
            paths.append(a)

    packs = (rules_conc,) if conc_only else None
    if show_rules:
        engine = build_engine(packs)
        for r in sorted(engine.rules.values(), key=lambda r: r.id):
            out.write(f"{r.id:<6}{r.severity:<9}{r.doc}\n")
        return 0

    result = run_lint(paths, baseline_file=baseline,
                      telemetry_paths=telemetry, packs=packs)
    report = result.to_report()
    if as_json:
        out.write(json.dumps(report, indent=1) + "\n")
    else:
        for f in result.findings:
            out.write(f.render() + "\n")
        c = report["counts"]
        out.write(
            f"{c['errors']} error(s), {c['warnings']} warning(s) over "
            f"{c['files']} file(s); suppressed: {c['suppressed_inline']} "
            f"inline, {c['suppressed_baseline']} baseline\n")
    return 1 if result.findings else 0
