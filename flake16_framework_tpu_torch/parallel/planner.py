"""The sweep planner: the config grid as a handful of execution plans,
copied from the JAX package's ``parallel/planner.py`` (pure grid
arithmetic, no torch):

- ``plan_grid(configs, devices=...)`` groups configs by (model family,
  shape signature) into ``Plan``s. A family is (feature set, model): the
  axis that changes shapes; within one, flaky type, preprocessing and
  balancing are data. The shape signature (n, n_feat, n_trees, n_folds,
  cap) rides along as an explicit group key.
- Each plan is padded to a batch width that is a multiple of the device
  count (``pad_to``), the pad slots repeating the plan's first config.
  The port runs on one device, so its plans carry no padding.

Determinism: the same config set yields the same plans regardless of
input order. Members sort by their canonical grid index
(``config.iter_config_keys()``, the order that seeds per-config RNG),
plans by their first member's index, and plans carry those indices.
"""

from flake16_framework_tpu_torch import config as cfg


def canonical_indices():
    """{config_keys: canonical grid index}: the iter_config_keys() order
    that seeds per-config RNG (``SweepEngine``) and addresses fault
    injection (resilience/inject.py)."""
    return {tuple(k): i for i, k in enumerate(cfg.iter_config_keys())}


class Plan:
    """One executable unit: same-family configs, padded to a uniform
    batch, run by ``SweepEngine.run_plan``.

    - ``family``   — (feature_set, model): the axes that change shapes
    - ``configs``  — member config keys, canonical grid order
    - ``indices``  — their canonical grid indices (RNG / injection ids)
    - ``shape``    — (n, n_feat, n_trees, n_folds, cap) signature
    - ``batch``    — padded width (``pad_to``-aligned); ``pad`` slots of
      it repeat ``configs[0]`` and are masked out of every result
    """

    def __init__(self, family, configs, indices, shape, pad_to=1):
        self.family = tuple(family)
        self.configs = tuple(tuple(k) for k in configs)
        self.indices = tuple(int(i) for i in indices)
        self.shape = tuple(shape)
        self.pad_to = max(1, int(pad_to))
        self.batch = -(-len(self.configs) // self.pad_to) * self.pad_to
        self.pad = self.batch - len(self.configs)

    @property
    def padded_configs(self):
        """The device batch: members then pad repeats of the first."""
        return self.configs + (self.configs[0],) * self.pad

    @property
    def padded_indices(self):
        return self.indices + (self.indices[0],) * self.pad

    @property
    def mask(self):
        """Validity of each batch slot (False = pad)."""
        return (True,) * len(self.configs) + (False,) * self.pad

    @property
    def pad_waste_pct(self):
        return 100.0 * self.pad / self.batch

    def __repr__(self):
        return (f"Plan({'/'.join(self.family)}: {len(self.configs)} cfg "
                f"-> batch {self.batch}, shape {self.shape})")


def plan_shape(fs_name, model_name, *, n, n_folds, tree_overrides=None):
    """The (n, n_feat, n_trees, n_folds, cap) signature of one family's
    plan. ``cap`` is the sweep's resample bound (SMOTE at worst doubles
    the training set)."""
    n_trees = cfg.MODELS[model_name].n_trees
    if tree_overrides and model_name in tree_overrides:
        n_trees = tree_overrides[model_name]
    return (int(n), len(cfg.FEATURE_SETS[fs_name]), int(n_trees),
            int(n_folds), 2 * int(n))


def plan_grid(configs, *, devices=1, n, n_folds, tree_overrides=None,
              perf_lookup=None):
    """Group ``configs`` into Plans: one per (family, shape signature),
    members in canonical grid order, padded to a multiple of ``devices``.
    Order-independent: any permutation of ``configs`` yields identical
    plans. Configs outside the canonical grid are a caller bug and raise
    (their RNG index — hence their results — would be undefined).

    ``perf_lookup`` is the performance database's consult hook, injected
    as a callable (None until the port has one): shape tuple -> recorded
    knob dict.
    A recorded ``plan_pad_to`` that is a positive multiple of
    ``devices`` overrides the pad width — result-neutral by the Plan
    contract (pad slots repeat the first member and are masked out on
    the host), so a tuned batch alignment can never change scores.
    Anything else — no database, no row, no knob, an invalid value —
    falls through to ``devices`` bit-identically."""
    index_of = canonical_indices()
    seen = set()
    members = []
    for keys in configs:
        keys = tuple(keys)
        if keys not in index_of:
            raise ValueError(f"config {keys!r} is not in the "
                             f"{len(index_of)}-config "
                             f"grid; the planner cannot seed its RNG")
        if keys in seen:
            continue
        seen.add(keys)
        members.append(keys)
    members.sort(key=index_of.__getitem__)

    groups = {}
    for keys in members:
        family = (keys[1], keys[4])
        shape = plan_shape(*family, n=n, n_folds=n_folds,
                           tree_overrides=tree_overrides)
        groups.setdefault((family, shape), []).append(keys)
    plans = [
        Plan(family, group, [index_of[k] for k in group], shape,
             pad_to=_pad_to(shape, devices, perf_lookup))
        for (family, shape), group in groups.items()
    ]
    plans.sort(key=lambda p: p.indices[0])
    return plans


def _pad_to(shape, devices, perf_lookup):
    """The pad width for one plan shape: a recorded ``plan_pad_to`` when
    it is a positive multiple of ``devices``, else ``devices``."""
    if perf_lookup is None:
        return devices
    try:
        knobs = perf_lookup(shape) or {}
        pad = int(knobs.get("plan_pad_to"))
    except (TypeError, ValueError):
        return devices
    if pad > 0 and pad % max(1, int(devices)) == 0:
        return pad
    return devices


def plan_explain_grid(configs, *, devices=1, n, n_folds, n_explain,
                      tree_overrides=None):
    """``plan_grid`` for the whole-grid SHAP pass (``pipeline.shap_grid``):
    the same grouping and determinism, each plan's shape extended with
    ``n_explain``, the rows each member explains."""
    plans = plan_grid(configs, devices=devices, n=n, n_folds=n_folds,
                      tree_overrides=tree_overrides)
    return [Plan(p.family, p.configs, p.indices,
                 p.shape + (int(n_explain),), pad_to=devices)
            for p in plans]


def plan_table(plans):
    """Rows for the pre-run padding report: family, member count, padded
    batch/shape, pad waste."""
    return [{
        "family": "/".join(p.family),
        "configs": len(p.configs),
        "batch": p.batch,
        "padded_shape": list(p.shape),
        "pad": p.pad,
        "pad_waste_pct": round(p.pad_waste_pct, 2),
    } for p in plans]


def format_plan_table(plans):
    """The table as printable lines (one header + one per plan)."""
    rows = plan_table(plans)
    head = (f"{'family':<28} {'configs':>7} {'batch':>5} {'pad':>4} "
            f"{'waste%':>6}  shape (n, n_feat, trees, folds, cap)")
    lines = [head]
    for r in rows:
        lines.append(
            f"{r['family']:<28} {r['configs']:>7} {r['batch']:>5} "
            f"{r['pad']:>4} {r['pad_waste_pct']:>6.1f}  "
            f"{tuple(r['padded_shape'])}")
    total = sum(r["configs"] for r in rows)
    dispatches = len(rows)
    lines.append(f"{total} config(s) -> {dispatches} plan(s) = "
                 f"{dispatches} whole-grid fit dispatch(es)")
    return lines
