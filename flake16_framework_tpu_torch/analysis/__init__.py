"""The port's static analysis and its audit: the lint engine and its
rule packs, and the audit's recorder and I-rules, copies of the JAX
package's ``analysis/``, the jaxpr walk replaced by a recorded run.

    python -m flake16_framework_tpu_torch lint [PATHS] [--json]
        [--baseline F] [--telemetry PATH] [--rules] [--concurrency]
        [--ir [--backend cuda|cpu]]
    python -m flake16_framework_tpu_torch audit [--json] [--budget-mb MB]
        [--n N] [--trees T] [--max-depth D] [--backend cuda|cpu]

Engine mechanics in engine.py; rule packs in rules_torch.py (J-rules,
PyTorch host hygiene), rules_grid.py (G-rules), rules_obs.py (O-rules),
rules_ir.py (I-rules, the audit) and rules_conc.py (C-rules, over the
thread and lock model of concurrency.py, which ``obs/lockwatch.py``
reconciles its runtime witness against); the audit's recorder in ir.py;
CLI in cli.py; the baseline writer in baseline.py.

Import contract, the JAX package's: nothing under ``analysis/`` imports
torch or jax at module load except ``ir.py``, which imports torch and is
imported lazily, by the audit alone (``audit``, ``lint --ir``) — the
lint is a host-only pre-flight that never touches a device.
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
