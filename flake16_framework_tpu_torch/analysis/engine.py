"""The lint engine: AST static analysis of host code, a copy of the JAX
package's ``analysis/engine.py``. Telemetry (``obs/``) explains a run
after the fact; the lint refuses classes of defect before a run starts.

Mechanics, not rules, live here. A rule *pack* is a module exposing

    RULES : {rule_id: RuleInfo}            # the pack's catalog
    check_module(mod)  -> iter[Finding]    # optional, per parsed file
    check_project(mods) -> iter[Finding]   # optional, once per lint run

(the packs: ``rules_torch`` — PyTorch host hygiene, the J ids;
``rules_grid`` — the config grid's pre-flight; ``rules_obs`` — telemetry
schema drift; ``rules_ir`` — the audit's catalog, whose findings come
from ``audit``; ``rules_conc`` — concurrency). The engine parses each
``.py`` once into a ``Module`` (source + AST + suppression table) and
funnels every pack's findings through the two suppression layers:

- inline: ``# f16lint: disable=J202,J402`` on the offending line (bare
  ``disable`` silences every rule on that line); ``disable-file=RULE``
  anywhere in the file silences a rule for the whole file.
- baseline: a JSON file of finding fingerprints (multiset — N entries
  absorb N findings). Fingerprints hash (path, rule, source snippet),
  not line numbers, so unrelated edits above a known finding don't
  invalidate the baseline. ``python -m
  flake16_framework_tpu_torch.analysis.baseline`` writes one.

Fingerprints and the baseline document (``flake16-lint-baseline-v2``)
are the JAX package's, so a baseline written by either engine loads in
the other, as long as it names only rule ids the loading catalog has.
The J pack's baseline section is named ``torch`` here (``jax`` in the
JAX package); loading reads every section whatever its name.

Nothing here imports torch or jax: the lint is a host-only pre-flight
that must not negotiate a device backend (the audit's recorder,
``analysis/ir.py``, is the one module of ``analysis/`` that imports
torch, and only the audit imports it).
"""

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass

ERROR, WARNING = "error", "warning"
# v2 groups fingerprints per rule pack so a pack added AFTER baseline
# generation cannot silently absorb findings it never saw (a v1 flat
# list regenerated before a pack existed would swallow its findings
# wholesale). v1 documents still load.
BASELINE_SCHEMA = "flake16-lint-baseline-v2"
BASELINE_SCHEMA_V1 = "flake16-lint-baseline-v1"

# Rule-id prefix letter -> pack section name in a v2 baseline. The
# fingerprint format (``RULE:hash``) keeps the rule id recoverable, so
# grouping needs no extra bookkeeping at save time.
PACK_PREFIXES = {"E": "engine", "J": "torch", "G": "grid", "O": "obs",
                 "I": "ir", "C": "concurrency"}


def pack_of(rule_id):
    pack = PACK_PREFIXES.get(rule_id[:1])
    if pack is None:
        raise ValueError(f"rule id {rule_id!r} matches no known pack "
                         f"(prefixes: {sorted(PACK_PREFIXES)})")
    return pack

# One engine-owned rule: a file the AST rules never saw is a finding, not
# a silent skip (a syntax error in a sweep module would otherwise pass).
PARSE_RULE = "E001"


@dataclass(frozen=True)
class RuleInfo:
    id: str
    severity: str
    doc: str


ENGINE_RULES = {
    PARSE_RULE: RuleInfo(PARSE_RULE, ERROR, "file does not parse"),
}


@dataclass
class Finding:
    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str
    snippet: str = ""

    @property
    def fingerprint(self):
        """Stable identity for baselines: path + rule + source snippet
        (NOT the line number — edits above a finding must not churn the
        baseline)."""
        h = hashlib.sha1(
            f"{self.path}::{self.rule}::{self.snippet.strip()}".encode()
        ).hexdigest()[:16]
        return f"{self.rule}:{h}"

    def as_dict(self):
        return {
            "rule": self.rule, "severity": self.severity, "path": self.path,
            "line": self.line, "col": self.col, "message": self.message,
            "fingerprint": self.fingerprint,
        }

    def render(self):
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} [{self.severity}] {self.message}")


_DISABLE_RE = re.compile(
    r"#\s*f16lint:\s*disable(?P<file>-file)?"
    r"(?:=(?P<rules>[A-Za-z0-9_,\s-]+))?")


class Module:
    """One parsed source file: AST + per-line/per-file suppression table.

    ``tree`` is None when the file does not parse; the engine turns that
    into a PARSE_RULE finding instead of running rules on it."""

    def __init__(self, path, src=None):
        self.path = normpath(path)
        if src is None:
            with open(path, encoding="utf-8", errors="replace") as fd:
                src = fd.read()
        self.src = src
        self.lines = src.splitlines()
        self.tree = None
        self.parse_error = None
        try:
            self.tree = ast.parse(src)
        except SyntaxError as e:
            self.parse_error = e
        self.file_disables = set()
        self.line_disables = {}
        for lineno, line in enumerate(self.lines, start=1):
            m = _DISABLE_RE.search(line)
            if not m:
                continue
            rules = m.group("rules")
            ids = ({r.strip() for r in rules.split(",") if r.strip()}
                   if rules else {"*"})
            if m.group("file"):
                self.file_disables |= ids
            else:
                self.line_disables.setdefault(lineno, set()).update(ids)

    def suppressed(self, rule, line):
        if "*" in self.file_disables or rule in self.file_disables:
            return True
        ids = self.line_disables.get(line)
        return ids is not None and ("*" in ids or rule in ids)

    def line_text(self, lineno):
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def finding(self, rule_id, severity, node, message):
        """Finding anchored at an AST node, snippet auto-filled."""
        line = getattr(node, "lineno", 0)
        return Finding(rule_id, severity, self.path, line,
                       getattr(node, "col_offset", 0), message,
                       snippet=self.line_text(line))


def normpath(path):
    """Repo-relative posix path when under the CWD (stable fingerprints
    across checkouts), absolute otherwise."""
    apath = os.path.abspath(path)
    cwd = os.getcwd()
    if apath == cwd or apath.startswith(cwd + os.sep):
        apath = os.path.relpath(apath, cwd)
    return apath.replace(os.sep, "/")


def iter_py_files(paths):
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        elif p.endswith(".py") or os.path.isfile(p):
            yield p


class LintResult:
    def __init__(self, findings, *, suppressed_inline, suppressed_baseline,
                 n_files, rules):
        self.findings = findings
        self.suppressed_inline = suppressed_inline
        self.suppressed_baseline = suppressed_baseline
        self.n_files = n_files
        self.rules = rules

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity == WARNING]

    def to_report(self):
        """The ``lint-report-v1`` document (obs.schema.LINT_SCHEMA — the
        same JSONL/JSON schema family as telemetry events and reports)."""
        from flake16_framework_tpu_torch.obs import schema

        return {
            "schema": schema.LINT_SCHEMA,
            "findings": [f.as_dict() for f in self.findings],
            "counts": {
                "errors": len(self.errors),
                "warnings": len(self.warnings),
                "suppressed_inline": self.suppressed_inline,
                "suppressed_baseline": self.suppressed_baseline,
                "files": self.n_files,
            },
            "rules": {r.id: {"severity": r.severity, "doc": r.doc}
                      for r in sorted(self.rules.values(),
                                      key=lambda r: r.id)},
            # Additive (validate_lint_report is permissive on extras, so
            # flake16-lint-report-v1 consumers are unaffected): the pack
            # sections this run's catalog spans, baseline-v2 vocabulary.
            "packs": sorted({pack_of(rid) for rid in self.rules}),
        }


class Engine:
    """Run rule packs over paths; apply suppressions and baseline."""

    def __init__(self, packs):
        self.packs = list(packs)
        self.rules = dict(ENGINE_RULES)
        for p in self.packs:
            dup = set(self.rules) & set(p.RULES)
            if dup:
                raise ValueError(f"duplicate rule ids across packs: {dup}")
            self.rules.update(p.RULES)

    def parse(self, paths):
        return [Module(f) for f in iter_py_files(paths)]

    def lint(self, paths, baseline=None):
        modules = self.parse(paths)
        findings = []
        for mod in modules:
            if mod.tree is None:
                e = mod.parse_error
                findings.append(Finding(
                    PARSE_RULE, ERROR, mod.path, e.lineno or 0,
                    (e.offset or 1) - 1, f"syntax error: {e.msg}",
                    snippet=e.text or ""))
                continue
            for p in self.packs:
                check = getattr(p, "check_module", None)
                if check is not None:
                    findings.extend(check(mod))
        parsed = [m for m in modules if m.tree is not None]
        for p in self.packs:
            check = getattr(p, "check_project", None)
            if check is not None:
                findings.extend(check(parsed))

        by_path = {m.path: m for m in modules}
        kept, n_inline = [], 0
        for f in findings:
            mod = by_path.get(f.path)
            if mod is not None and mod.suppressed(f.rule, f.line):
                n_inline += 1
            else:
                kept.append(f)

        budget = {}
        for fp in (baseline or ()):
            budget[fp] = budget.get(fp, 0) + 1
        final, n_base = [], 0
        for f in kept:
            fp = f.fingerprint
            if budget.get(fp, 0) > 0:
                budget[fp] -= 1
                n_base += 1
            else:
                final.append(f)
        final.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return LintResult(
            final, suppressed_inline=n_inline, suppressed_baseline=n_base,
            n_files=len(modules), rules=self.rules)


def load_baseline(path, rules=None):
    """Fingerprint list from a baseline file (empty when absent: a fresh
    checkout with no baseline is not a lint failure). Reads both v2
    (per-pack sections) and legacy v1 (flat list). When ``rules`` — the
    engine's rule catalog — is given, any fingerprint whose rule id is
    unknown raises instead of silently suppressing nothing (a typo or a
    renamed rule in a baseline is stale suppression debt, not noise)."""
    if path is None or not os.path.exists(path):
        return []
    with open(path) as fd:
        obj = json.load(fd)
    schema = obj.get("schema") if isinstance(obj, dict) else None
    if schema == BASELINE_SCHEMA:
        packs = obj.get("packs", {})
        fps = [fp for pack in sorted(packs) for fp in packs[pack]]
    elif schema == BASELINE_SCHEMA_V1:
        fps = list(obj.get("fingerprints", []))
    else:
        raise ValueError(
            f"{path}: not a {BASELINE_SCHEMA} (or {BASELINE_SCHEMA_V1}) "
            "baseline document")
    if rules is not None:
        unknown = sorted({fp.split(":", 1)[0] for fp in fps}
                         - set(rules))
        if unknown:
            raise ValueError(
                f"{path}: baseline names rule id(s) unknown to the "
                f"catalog: {unknown} — regenerate with "
                "python -m flake16_framework_tpu_torch.analysis.baseline")
    return fps


def group_fingerprints(findings):
    """{pack: sorted fingerprint list} for a finding set — the v2
    baseline body."""
    packs = {}
    for f in findings:
        packs.setdefault(pack_of(f.rule), []).append(f.fingerprint)
    return {pack: sorted(fps) for pack, fps in sorted(packs.items())}


def save_baseline(path, findings, *, keep_packs=None):
    """Write a v2 baseline. ``keep_packs`` ({pack: [fingerprints]})
    carries sections to preserve verbatim — the per-pack regeneration
    path: packs regenerated from ``findings`` override, others survive
    untouched."""
    packs = dict(keep_packs or {})
    packs.update(group_fingerprints(findings))
    obj = {
        "schema": BASELINE_SCHEMA,
        "packs": {pack: packs[pack] for pack in sorted(packs)},
    }
    from flake16_framework_tpu_torch.utils.atomic import atomic_write

    with atomic_write(path, "w") as fd:
        json.dump(obj, fd, indent=1)
        fd.write("\n")
    return obj
