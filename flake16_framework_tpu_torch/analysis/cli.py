"""The ``lint`` and ``audit`` CLI verbs (``__main__.py``), a copy of the
JAX package's ``analysis/cli.py``:

    python -m flake16_framework_tpu_torch lint [PATHS...] [--json]
        [--baseline FILE] [--telemetry PATH] [--rules] [--concurrency]
        [--ir [--backend cuda|cpu] [--per-family K]]
    python -m flake16_framework_tpu_torch audit [--json] [--budget-mb MB]
        [--n N] [--trees T] [--max-depth D] [--backend cuda|cpu]
        [--per-family K]

With no PATHS the package itself is linted (the gate invocation; the
package lints clean). ``--json`` prints the ``lint-report-v1`` document
(obs.schema.LINT_SCHEMA — same schema family as telemetry, validated by
the same drift lint). ``--baseline`` subtracts a recorded fingerprint
multiset (``python -m flake16_framework_tpu_torch.analysis.baseline``
writes one). ``--telemetry`` additionally validates emitted telemetry
documents at PATH (repeatable). ``--rules`` prints the rule catalog and
exits 0. ``--concurrency`` restricts the run to the concurrency pack
(C101–C503, rules_conc) — the focused invocation for auditing the
threaded serving substrate. ``--ir`` folds the audit's findings into the
lint run (imports torch — the one lint path that does) on ``--backend``.

``audit`` is the standalone audit gate: it runs every real entry point
(the plan executors over the whole grid, the serving entries, the SHAP
engines) under the recorder (``analysis/ir.py``) and runs the I-rule
pack (``analysis/rules_ir.py``) — the census reconciliation, the
declared host reads, determinism and wide dtypes, and each entry's
measured memory envelope. Exit 0 = every contract holds; findings print
in lint format. Both take ``--backend``: ``cuda`` unless the caller asks
for the CPU, and without CUDA they raise (no silent CPU path), as ``tune``
does. The JAX audit's ``--no-mesh`` is refused: the port runs one card and
has no mesh. ``--per-family K``, the port's own option, audits the first
K configs of each family (``rules_ir.family_sample``) instead of the
whole grid: every plan of the census still runs, each over fewer
members.

Exit status: 0 = no unsuppressed findings, 1 = findings, 2 = usage error
(``UsageError``, a ValueError; ``python -m`` prints it and exits 2).
"""

import json
import os
import sys

from flake16_framework_tpu_torch.analysis import engine as eng
from flake16_framework_tpu_torch.analysis import (
    rules_conc, rules_grid, rules_ir, rules_obs, rules_torch,
)

# rules_ir registers its catalog only (no check_* hooks): plain lint
# stays torch-free; I-findings come from run_audit via ``audit``/``--ir``.
# Every other pack runs in every lint — pure AST, dogfooded to zero on
# the package.
PACKS = (rules_torch, rules_grid, rules_obs, rules_ir, rules_conc)

NO_MESH_REFUSED = ("audit --no-mesh: the port runs on one card and has no "
                   "mesh, so there is no mesh program to leave out")
USAGE_EXIT = 2


class UsageError(ValueError):
    """A usage error of ``lint`` or ``audit``: ``python -m`` exits 2."""


def default_paths():
    """The package directory — what the gate lints."""
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def build_engine(packs=None):
    return eng.Engine(PACKS if packs is None else packs)


def run_lint(paths=None, baseline_file=None, telemetry_paths=(),
             ir=False, backend=None, packs=None, configs=None):
    """The LintResult for PATHS, telemetry-document findings folded in.
    With ``ir`` the audit's findings join the result (imports torch; on
    ``backend``, over ``configs``, default the whole grid). ``packs``
    restricts the run (the ``--concurrency`` focus flag)."""
    engine = build_engine(packs)
    result = engine.lint(paths or default_paths(),
                         baseline=eng.load_baseline(baseline_file,
                                                    rules=engine.rules))
    if telemetry_paths:
        result.findings.extend(rules_obs.check_docs(telemetry_paths))
    if ir:
        ir_findings, _info = rules_ir.run_audit(backend=backend,
                                                configs=configs)
        result.findings.extend(ir_findings)
    return result


def lint_main(args, out=None):
    out = out or sys.stdout
    as_json = False
    show_rules = False
    with_ir = False
    conc_only = False
    baseline = None
    backend = None
    per_family = None
    telemetry = []
    paths = []
    it = iter(args)
    for a in it:
        if a == "--json":
            as_json = True
        elif a == "--per-family":
            per_family = next(it, None)
            if per_family is None:
                raise UsageError("--per-family needs a count")
            per_family = int(per_family)
        elif a == "--rules":
            show_rules = True
        elif a == "--ir":
            with_ir = True
        elif a == "--concurrency":
            conc_only = True
        elif a == "--baseline":
            baseline = next(it, None)
            if baseline is None:
                raise UsageError("--baseline needs a file argument")
        elif a == "--backend":
            backend = next(it, None)
            if backend is None:
                raise UsageError("--backend needs cuda or cpu")
        elif a == "--telemetry":
            t = next(it, None)
            if t is None:
                raise UsageError("--telemetry needs a path argument")
            telemetry.append(t)
        elif a.startswith("--"):
            raise UsageError(f"Unrecognized lint option {a!r}")
        else:
            paths.append(a)
    if backend is not None and not with_ir:
        raise UsageError("lint --backend: only the audit (--ir) runs on a "
                         "device")
    if per_family is not None and not with_ir:
        raise UsageError("lint --per-family: only the audit (--ir) runs "
                         "configs")

    packs = (rules_conc,) if conc_only else None
    if show_rules:
        engine = build_engine(packs)
        for r in sorted(engine.rules.values(), key=lambda r: r.id):
            out.write(f"{r.id:<6}{r.severity:<9}{r.doc}\n")
        return 0

    result = run_lint(paths, baseline_file=baseline,
                      telemetry_paths=telemetry, ir=with_ir,
                      backend=backend, packs=packs,
                      configs=None if per_family is None
                      else rules_ir.family_sample(per_family))
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


def audit_report(findings, info):
    """The ``audit-report-v1`` document (obs.schema.AUDIT_SCHEMA), the
    JAX package's fields plus ``backend`` (and, on each envelope, the
    hist window ``width`` it ran at)."""
    from flake16_framework_tpu_torch.obs import schema

    errors = [f for f in findings if f.severity == eng.ERROR]
    return {
        "schema": schema.AUDIT_SCHEMA,
        "backend": info["backend"],
        "findings": [f.as_dict() for f in findings],
        "counts": {"errors": len(errors),
                   "warnings": len(findings) - len(errors),
                   "entries": len(info["entries"])},
        "census": info["census"],
        "shap_census": info.get("shap_census"),
        "envelopes": info["envelopes"],
        "entries": info["entries"],
        "budget_mb": info["budget_mb"],
    }


def audit_main(args, out=None):
    out = out or sys.stdout
    as_json = False
    kw = {}
    it = iter(args)

    def arg(flag):
        v = next(it, None)
        if v is None:
            raise UsageError(f"{flag} needs an argument")
        return v

    for a in it:
        if a == "--json":
            as_json = True
        elif a == "--budget-mb":
            kw["budget_mb"] = float(arg(a))
        elif a == "--n":
            kw["n"] = int(arg(a))
        elif a == "--trees":
            kw["n_trees"] = int(arg(a))
        elif a == "--max-depth":
            kw["max_depth"] = int(arg(a))
        elif a == "--backend":
            kw["backend"] = arg(a)
        elif a == "--per-family":
            kw["configs"] = rules_ir.family_sample(int(arg(a)))
        elif a == "--no-mesh":
            raise UsageError(NO_MESH_REFUSED)
        else:
            raise UsageError(f"Unrecognized audit option {a!r}")

    findings, info = rules_ir.run_audit(**kw)
    if as_json:
        out.write(json.dumps(audit_report(findings, info), indent=1)
                  + "\n")
    else:
        for f in findings:
            out.write(f.render() + "\n")
        c = info["census"]
        sc = info.get("shap_census") or {}
        out.write(
            f"audit: {len(info['entries'])} entr(ies) traced on "
            f"{info['backend']}; census static={c['static']} "
            f"runtime={c['runtime']} ({c['source']}); shap census "
            f"static={sc.get('static')} runtime={sc.get('runtime')} "
            f"({sc.get('source')}); {len(findings)} finding(s)\n")
        for env in info["envelopes"]:
            reads = sum(env["host_reads"].values())
            out.write(
                f"  {env['entry']:<52} batch={env['batch']!s:<4} "
                f"peak={env['peak_mb']:.2f} MB reads={reads} "
                f"k1={env['k1_launches']} k2={env['k2_launches']} "
                f"ops={env['aten_ops']} wall={env['wall_s']:.2f}s\n")
    return 1 if findings else 0
