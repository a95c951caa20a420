"""Write a lint baseline file from the current findings, the port's copy
of the JAX package's ``tools/gen_lint_baseline.py``:

    python -m flake16_framework_tpu_torch.analysis.baseline [PATHS...]
        [--out FILE] [--pack NAME]

Runs every rule pack (inline suppressions still apply — a baseline
records what inline comments do NOT already silence) over PATHS
(default: the package, like the gate) and writes the findings'
fingerprints to FILE (default ``lint_baseline.json`` in the working
directory) in the v2 per-pack schema. Re-linting with ``--baseline
FILE`` then exits 0 until NEW findings appear — the ratchet for
adopting a rule on code with existing debt.

``--pack NAME`` (torch | grid | obs | ir | concurrency | engine) regenerates
ONLY that pack's section and keeps every other pack's fingerprints
verbatim. A baseline that names a rule id unknown to the catalog fails
loudly (``engine.load_baseline``) instead of suppressing nothing.

The package itself lints clean and ships no baseline; this writer is
for forks and for staging new rules.
"""

import json
import os
import sys

from flake16_framework_tpu_torch.analysis import engine as eng
from flake16_framework_tpu_torch.analysis.cli import build_engine, run_lint

DEFAULT_OUT = "lint_baseline.json"


def main(argv, out=None):
    out = out or sys.stdout
    out_file = DEFAULT_OUT
    pack = None
    paths = []
    it = iter(argv)
    for a in it:
        if a == "--out":
            out_file = next(it, None)
            if out_file is None:
                raise ValueError("--out needs a file argument")
        elif a == "--pack":
            pack = next(it, None)
            if pack is None:
                raise ValueError("--pack needs a pack name argument")
            if pack not in eng.PACK_PREFIXES.values():
                raise ValueError(
                    f"unknown pack {pack!r} (known: "
                    f"{sorted(eng.PACK_PREFIXES.values())})")
        elif a.startswith("--"):
            raise ValueError(f"Unrecognized option {a!r}")
        else:
            paths.append(a)

    # Validate any existing baseline against the live catalog FIRST: a
    # stale fingerprint (renamed/removed rule) must fail the regen, not
    # ride along silently.
    catalog = build_engine().rules
    eng.load_baseline(out_file if os.path.exists(out_file) else None,
                      rules=catalog)

    result = run_lint(paths or None)
    findings = result.findings
    keep = None
    if pack is not None:
        findings = [f for f in findings if eng.pack_of(f.rule) == pack]
        keep = {}
        if os.path.exists(out_file):
            with open(out_file) as fd:
                obj = json.load(fd)
            if obj.get("schema") == eng.BASELINE_SCHEMA:
                keep = {p: fps for p, fps in obj.get("packs", {}).items()
                        if p != pack}
            # v1 flat lists cannot be split per-pack; the rule-id prefix
            # in each fingerprint recovers the grouping.
            elif obj.get("schema") == eng.BASELINE_SCHEMA_V1:
                for fp in obj.get("fingerprints", []):
                    p = eng.pack_of(fp.split(":", 1)[0])
                    if p != pack:
                        keep.setdefault(p, []).append(fp)
    eng.save_baseline(out_file, findings, keep_packs=keep)
    scope = f"pack {pack!r}" if pack else "all packs"
    out.write(f"wrote {len(findings)} fingerprint(s) ({scope}) to "
              f"{out_file}\n")
    for f in findings:
        out.write(f"  {f.fingerprint}  {f.render()}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
