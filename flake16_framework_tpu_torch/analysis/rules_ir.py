"""Rule pack 4 — the audit's I-rules, the port's counterpart of the JAX
package's ``analysis/rules_ir.py``, with the same rule ids.

The pack registers its catalog with the lint engine (so ``--rules``,
baselines and fingerprints know the I ids) but contributes no
``check_module``/``check_project``: its findings come only from the
audit (the ``audit`` verb and ``lint --ir``), which runs each real entry
point under ``analysis/ir.py``'s recorder, so plain lint never imports
torch.

Rules:

- I101 (error): a host read at an undeclared site. The JAX contract is
  "no host callback in a jit program"; the port reads the host on
  purpose, so its contract is the declared list ``DECLARED_READS``, each
  site with its reason, and a read anywhere else is a finding. The
  serving entries declare none: ``store.call`` returns a device tensor,
  and the batcher reads it once, outside the entry.
- I102 (warning): the recorder found an undeclared host read, and the J
  pack (``rules_torch`` J402/J601) reports nothing in the module where
  the read happens — the AST heuristic's ground-truth cross-check.
- I201 (error): a nondeterministic op: a random aten op, or (on
  ``cuda``) an op PyTorch's deterministic mode flags — journal resume
  would not be bit-identical.
- I202 (error): a float64 or complex128 value outside the sites that take
  float64 on purpose for XLA:CPU's bits (``DECLARED_WIDE``).
- I301 (error): the static census (``len(plan_grid(...))``, and the SHAP
  arm's ``len(plan_explain_grid(...))``) differs from the number of plan
  windows the executor opened. A ``runtime_count`` from the caller still
  wins, as in the JAX package. The JAX audit reads its runtime side from
  the newest ``BENCH_r*.json``; those are the JAX benchmark's, and the
  port has no benchmark yet, so its runtime side is the audit's own run
  of the executor (``"source": "executor"``).
- I401 (error): an entry's measured ``peak_bytes`` exceeds
  ``F16_DEVICE_BUDGET_MB`` (or ``--budget-mb``).

Not ported: I501 (the ``shard_map`` config-axis audit). The port runs
on one card and has no mesh and no ``shard_map``, and a rule that can
never fire is not ported.

Module-import contract: nothing here imports torch at module level; the
finding builders import ``analysis/ir.py`` lazily.
"""

import os

from flake16_framework_tpu_torch.analysis.engine import (
    ERROR, WARNING, Finding, Module, RuleInfo,
)

PACK_NAME = "ir"

RULES = {r.id: r for r in (
    RuleInfo("I101", ERROR,
             "host read at an undeclared site in a recorded entry — a"
             " device->host round trip the contract does not allow"),
    RuleInfo("I102", WARNING,
             "the recorder found an undeclared host read that the J402/"
             "J601 AST heuristics miss in the reading module"),
    RuleInfo("I201", ERROR,
             "nondeterministic op in a recorded entry — breaks"
             " bit-identical journal resume"),
    RuleInfo("I202", ERROR,
             "float64/complex128 value outside the declared f64 sites —"
             " wide-dtype drift"),
    RuleInfo("I301", ERROR,
             "static plan census != the plan windows the executor opened"
             " — the one-plan-per-family contract drifted"),
    RuleInfo("I401", ERROR,
             "entry's measured peak memory exceeds the device budget"
             " (F16_DEVICE_BUDGET_MB) — would OOM"),
)}

_PKG = "flake16_framework_tpu_torch"
# Where each recorded entry is defined: findings anchor there, with the
# entry named in the message and the fingerprint keyed on the entry.
_SWEEP_PATH = f"{_PKG}/parallel/sweep.py"
_PIPELINE_PATH = f"{_PKG}/pipeline.py"
_SERVE_PATH = f"{_PKG}/serve/store.py"
_SHAP_PATH = f"{_PKG}/ops/treeshap.py"

# The host reads the port makes on purpose: (module, function) -> reason.
DECLARED_READS = {
    (f"{_PKG}/ops/trees.py", "_grow_trees"):
        "the hist grower's loop condition, (p < a).any(): one read a BFS "
        "step",
    (f"{_PKG}/ops/trees.py", "_fit_trees_exact"):
        "the exact grower's loop condition, one read a level (a one-tree "
        "batch reads its split count instead)",
    (f"{_PKG}/parallel/sweep.py", "_key_bytes"):
        "the fold keys' journal bytes, read once a config",
    (f"{_PKG}/parallel/sweep.py", "run_config"):
        "a fold's synchronize (its train clock) and its counts' copy, "
        "one of each a fold on the staged path",
    (f"{_PKG}/parallel/sweep.py", "_fit_count_folds"):
        "the counts' copy, one a config on the fold-batched path",
    (f"{_PKG}/resilience/guard.py", "_finish"):
        "the guard's synchronize, which lands a CUDA error inside the "
        "guard of the config that caused it",
    (f"{_PKG}/ops/treeshap.py", "bucket_inputs"):
        "the SHAP work list packed on the host: max(n_nodes), u and "
        "valid, once a forest",
    (f"{_PKG}/pipeline.py", "shap_for_config"):
        "the fit's synchronize (its clock) and the values' copy, one of "
        "each a config",
}

# The sites that take float64 on purpose: (module, function) -> reason.
DECLARED_WIDE = {
    (f"{_PKG}/ops/trees.py", "_fma"):
        "XLA:CPU's fused multiply-add, rounded once through float64",
    (f"{_PKG}/ops/preprocess.py", "_scaler_params"):
        "the scaler's correctly rounded square root, taken in float64",
    (f"{_PKG}/ops/treeshap.py", "interventional_tables"):
        "the closed form's weights, float64 quotients rounded once",
    (f"{_PKG}/kernels/treeshap_unit.py", "unit_tables"):
        "K2's coefficient tables, float64 quotients rounded once",
}


def _finding(rule_id, message, *, path, entry):
    return Finding(rule_id, RULES[rule_id].severity, path, 0, 0,
                   message, snippet=entry)


def _site_key(site):
    """(module, function) of a recorded ``path:line (function)`` site."""
    path, _, rest = site.partition(":")
    return path, rest.partition("(")[2].rstrip(")")


# -- I3: the static census (host only, no torch) ------------------------


def _config_list(configs):
    from flake16_framework_tpu_torch import config as cfg

    return [tuple(k) for k in (configs or cfg.iter_config_keys())]


def family_sample(per_family):
    """The first ``per_family`` configs of each family (feature set,
    model) in the canonical grid order: a sub-grid on which every plan
    of the whole grid's census still runs (the CLI's ``--per-family``)."""
    from flake16_framework_tpu_torch import config as cfg

    if per_family < 1:
        raise ValueError(f"--per-family must be at least 1, got "
                         f"{per_family}")
    taken = {}
    out = []
    for keys in cfg.iter_config_keys():
        fam = (keys[1], keys[4])
        if taken.get(fam, 0) < per_family:
            taken[fam] = taken.get(fam, 0) + 1
            out.append(tuple(keys))
    return out


def static_plans(*, n=120, n_folds=10, devices=1, tree_overrides=None,
                 configs=None):
    """The grid's execution plans (``configs``, default: the whole grid)
    — the static census is ``len()`` of this. Host only: the planner and
    the config import no torch."""
    from flake16_framework_tpu_torch.parallel import planner

    return planner.plan_grid(
        _config_list(configs), devices=devices, n=n, n_folds=n_folds,
        tree_overrides=tree_overrides)


def static_shap_plans(*, n=120, n_folds=10, n_explain=16, devices=1,
                      tree_overrides=None, configs=None):
    """The SHAP arm's plans (``planner.plan_explain_grid``)."""
    from flake16_framework_tpu_torch.parallel import planner

    return planner.plan_explain_grid(
        _config_list(configs), devices=devices, n=n, n_folds=n_folds,
        n_explain=n_explain, tree_overrides=tree_overrides)


def _census(plans, runtime_count, source, *, what, drift, entry):
    static_n = len(plans)
    grid_size = sum(len(p.configs) for p in plans)
    if runtime_count is None:
        return [], {"static": static_n, "runtime": None, "source": None,
                    "match": None}
    findings = []
    if int(runtime_count) != static_n:
        findings.append(_finding(
            "I301",
            f"static {what} census is {static_n} plan(s) for the "
            f"{grid_size}-config grid but the runtime census "
            f"({source}) measured {int(runtime_count)} dispatches — "
            f"the {drift} contract drifted", path=_SWEEP_PATH,
            entry=entry))
    return findings, {"static": static_n, "runtime": int(runtime_count),
                      "source": source,
                      "match": int(runtime_count) == static_n}


def census_findings(plans=None, *, runtime_count=None, source="caller"):
    """I301: the static census against the runtime one, which the caller
    measured (``source`` names where from); None leaves the census
    unreconciled (``match`` None)."""
    plans = static_plans() if plans is None else plans
    return _census(plans, runtime_count, source, what="dispatch",
                   drift="one-program-per-family",
                   entry="grid_dispatch_count")


def shap_census_findings(plans=None, *, runtime_count=None,
                         source="caller"):
    """I301 for the SHAP arm: the planner groups the explain grid as the
    fit grid (``plan_explain_grid`` delegates to ``plan_grid``), so the
    static SHAP census is the plan count."""
    plans = static_plans() if plans is None else plans
    return _census(plans, runtime_count, source, what="SHAP dispatch",
                   drift="one-explain-program-per-family",
                   entry="shap_dispatch_count")


# -- per-entry records -> findings ------------------------------------------


def program_findings(entry, record, *, path, declared=None):
    """I101/I201/I202 findings for one recorded entry (``ir.Recorder``'s
    record); ``declared`` is the entry's declared host-read sites
    (default ``DECLARED_READS``)."""
    declared = DECLARED_READS if declared is None else declared
    findings = []
    for site, n in record["host_reads"].items():
        if _site_key(site) not in declared:
            findings.append(_finding(
                "I101", f"recorded entry {entry!r} reads the host at "
                f"{site} ({n} time(s)) — not a declared site",
                path=path, entry=f"{entry}:{site}"))
    for what, n in record["nondet"].items():
        findings.append(_finding(
            "I201", f"recorded entry {entry!r} runs nondeterministic op "
            f"{what} ({n} time(s)) — journal resume would not be "
            "bit-identical", path=path, entry=f"{entry}:{what}"))
    for what, n in record["wide"].items():
        site = what.partition(" @ ")[2]
        if _site_key(site) in DECLARED_WIDE:
            continue
        findings.append(_finding(
            "I202", f"recorded entry {entry!r}: {what} produces a wide "
            f"value ({n} time(s)) outside the declared float64 sites",
            path=path, entry=f"{entry}:{what}"))
    return findings


def budget_findings(entry, envelope, *, budget_mb, path=_SWEEP_PATH):
    """I401 finding when one entry's envelope exceeds the budget."""
    if not budget_mb or budget_mb <= 0:
        return []
    peak_mb = envelope["peak_bytes"] / 2**20
    if peak_mb <= budget_mb:
        return []
    return [_finding(
        "I401", f"plan program {entry!r} peak-memory envelope "
        f"{peak_mb:.1f} MB exceeds the device budget {budget_mb:g} MB "
        "(F16_DEVICE_BUDGET_MB) — would OOM on dispatch",
        path=path, entry=f"{entry}:budget")]


def crosscheck_findings(entry, record, *, declared=None, root=None):
    """I102: for each module where the recorder found an undeclared host
    read, a warning when the J pack's host-read rules (J402, J601) report
    nothing there — the heuristics' blind spot. ``root`` is where the
    sites' paths start (default: the repository)."""
    from flake16_framework_tpu_torch.analysis import rules_torch

    declared = DECLARED_READS if declared is None else declared
    root = root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    modules = sorted({_site_key(site)[0] for site in record["host_reads"]
                      if _site_key(site) not in declared})
    findings = []
    for rel in modules:
        try:
            ast_findings = list(rules_torch.check_module(
                Module(os.path.join(root, rel))))
        except OSError:
            continue
        if any(f.rule in ("J402", "J601") for f in ast_findings):
            continue
        findings.append(_finding(
            "I102", f"recorded entry {entry!r} reads the host in {rel} "
            "but the J402/J601 heuristics report nothing there — "
            "heuristic blind spot", path=rel, entry=f"{entry}:crosscheck"))
    return findings


# -- the whole audit ----------------------------------------------------


def _family(entry):
    """"FS/Model" of a plan entry ``name[FS/Model]``."""
    return entry[entry.index("[") + 1:-1]


def _envelope(record, *, batch, width):
    env = {k: record[k] for k in ("entry", "arg_bytes", "out_bytes",
                                  "peak_bytes", "allocator_peak_bytes",
                                  "k1_launches", "k2_launches",
                                  "aten_ops", "wall_s")}
    env.update(batch=batch, width=width, host_reads=record["host_reads"],
               nondet=record["nondet"],
               peak_mb=round(record["peak_bytes"] / 2**20, 2))
    return env


def run_audit(*, n=120, n_trees=2, n_folds=10, n_projects=26,
              max_depth=8, n_explain=16, n_background=8, budget_mb=None,
              backend=None, configs=None, runtime_count=None,
              runtime_shap_count=None):
    """Run every real entry point under the recorder and every I-rule.
    Returns (findings, info): ``info`` carries both census
    reconciliations, the per-entry envelope table (with host reads by
    site, K1/K2 launches, aten ops and walls), the entry list and the
    backend. The plan entries are the executors themselves over
    ``configs`` (default: the whole grid), and the runtime census is the
    plan windows they opened unless the caller gives one; the shape
    defaults are the JAX audit's (n = 120, 2 trees, depth 8, 16
    explained). ``backend`` is ``cuda`` unless the caller asks for the
    CPU (raises without CUDA). Each envelope carries the hist window
    ``width`` in force: for a hist plan the tuned width the executor
    consults (``perfdb.tuned_fit_overrides``), else the grower's default
    on the backend, so that the tuner scales every envelope from the
    width it was measured at."""
    from flake16_framework_tpu_torch import config as cfg
    from flake16_framework_tpu_torch.analysis import ir
    from flake16_framework_tpu_torch.device import resolve
    from flake16_framework_tpu_torch.obs import perfdb
    from flake16_framework_tpu_torch.ops import trees

    device = resolve(backend)
    if budget_mb is None:
        raw = os.environ.get("F16_DEVICE_BUDGET_MB", "")
        budget_mb = float(raw) if raw else None
    tree_overrides = {"Random Forest": n_trees, "Extra Trees": n_trees}
    configs = _config_list(configs)
    plans = {"/".join(p.family): p for p in static_plans(
        n=n, n_folds=n_folds, tree_overrides=tree_overrides,
        configs=configs)}
    shap_plans = static_shap_plans(n=n, n_folds=n_folds,
                                   n_explain=n_explain,
                                   tree_overrides=tree_overrides,
                                   configs=configs)
    data = ir.audit_data(n, n_projects)
    default_width = trees.default_node_batch(device.type)
    info = {"backend": device.type, "envelopes": [], "entries": []}
    findings = []

    def one(entry, record, *, path, batch=None, width=None,
            declared=None):
        info["entries"].append(entry)
        findings.extend(program_findings(entry, record, path=path,
                                         declared=declared))
        findings.extend(crosscheck_findings(entry, record,
                                            declared=declared))
        env = _envelope(record, batch=batch, width=width)
        info["envelopes"].append(env)
        findings.extend(budget_findings(entry, env, budget_mb=budget_mb,
                                        path=path))

    def width_of(plan):
        if not trees.hist_tier_default(plan.shape[2]):
            return default_width
        return perfdb.tuned_fit_overrides(
            device.type, plan.shape, model=plan.family[1]).get(
                "node_batch", default_width)

    records, opened, _ = ir.trace_plan_program(
        configs, data, device=device, max_depth=max_depth,
        tree_overrides=tree_overrides)
    for rec in records:
        pl = plans[_family(rec["entry"])]
        one(rec["entry"], rec, path=_SWEEP_PATH, batch=pl.batch,
            width=width_of(pl))
    census_f, info["census"] = census_findings(
        list(plans.values()), runtime_count=opened if runtime_count is None
        else runtime_count,
        source="executor" if runtime_count is None else "caller")
    findings.extend(census_f)

    # The SHAP arm: every plan in path mode, then both other modes on the
    # first plan (the mode engines are family-independent).
    records, opened, _ = ir.trace_shap_plan_program(
        configs, data, device=device, n_explain=n_explain,
        max_depth=max_depth, tree_overrides=tree_overrides)
    for mode in ("interventional", "interaction"):
        records += ir.trace_shap_plan_program(
            shap_plans[0].configs, data, device=device, mode=mode,
            n_explain=n_explain, n_background=n_background,
            max_depth=max_depth, tree_overrides=tree_overrides)[0]
    for rec in records:
        one(rec["entry"], rec, path=_PIPELINE_PATH,
            batch=plans[_family(rec["entry"])].batch,
            width=default_width)
    shap_f, info["shap_census"] = shap_census_findings(
        shap_plans, runtime_count=opened if runtime_shap_count is None
        else runtime_shap_count,
        source="executor" if runtime_shap_count is None else "caller")
    findings.extend(shap_f)

    for entry, (fn, args, kwargs) in serve_entries(
            data, device=device, n_trees=max(n_trees, 2),
            depth=max_depth).items():
        record, _ = ir.trace_entry(fn, args, kwargs, entry=entry,
                                   device=device)
        one(entry, record, path=_SERVE_PATH, width=default_width,
            declared={})
    for entry, (fn, args, kwargs) in ir.shap_kernel_entries(
            data, device=device, n_trees=max(n_trees, 2),
            depth=max_depth).items():
        record, _ = ir.trace_entry(fn, args, kwargs, entry=entry,
                                   device=device)
        one(entry, record, path=_SHAP_PATH, width=default_width)

    findings.sort(key=lambda f: (f.rule, f.path, f.snippet))
    info["budget_mb"] = budget_mb
    info["grid_configs"] = len(configs)
    return findings, info


def serve_entries(data, *, device, n_trees=2, depth=8, bucket=32):
    """The serving layer's entry points (``serve/store.ExecutableStore.
    audit_handles``) on a model registered from ``data`` (the first SHAP
    config at ``n_trees`` trees and depth ``depth``), each called on a
    ``bucket``-row batch of its real rows."""
    from flake16_framework_tpu_torch import config as cfg
    from flake16_framework_tpu_torch.serve.registry import fit_model
    from flake16_framework_tpu_torch.serve.store import ExecutableStore

    keys = cfg.SHAP_CONFIGS[0]
    model = fit_model(keys, data[0], data[1], max_depth=depth,
                      tree_overrides={keys[4]: n_trees}, device=device)
    x = data[0][:bucket][:, list(model.cols)]
    return ExecutableStore(None, device=device).audit_handles(model, x)
