"""The port's static analysis: the lint engine and its rule packs, copies
of the JAX package's ``analysis/`` without the jaxpr half.

    python -m flake16_framework_tpu_torch lint [PATHS] [--json]
        [--baseline F] [--telemetry PATH] [--rules] [--concurrency]

Engine mechanics in engine.py; rule packs in rules_torch.py (J-rules,
PyTorch host hygiene), rules_grid.py (G-rules), rules_obs.py (O-rules)
and rules_conc.py (C-rules, over the thread and lock model of
concurrency.py, which ``obs/lockwatch.py`` reconciles its runtime
witness against); CLI in cli.py; the baseline writer in baseline.py.

Import contract: nothing under ``analysis/`` imports torch or jax — the
lint is a host-only pre-flight that never touches a device. The JAX
package's ``ir.py``/``rules_ir.py`` (the ``audit`` verb and ``lint
--ir``) have no counterpart yet (ROADMAP.md §A 7).
"""

from flake16_framework_tpu_torch.analysis.engine import (  # noqa: F401
    Engine,
    Finding,
    LintResult,
    Module,
    RuleInfo,
    load_baseline,
    save_baseline,
)
