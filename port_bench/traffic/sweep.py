"""The study's sweep as traffic: a fixed list of configs run one at a
time through the plan executor until the window ends.

Parameters (``workloads/<cell>.json``):

- ``axes``: the values of each grid axis (flaky type, feature set,
  preprocessing, balancing, model); the configs are their product in the
  grid's canonical order, the same for every seed. The list restarts from
  its head in every run and cycles until the window ends.
- ``trace``: ``{"from": i, "count": k}``, the configs of the window the
  traced run profiles.
- ``check``: ``{"per_family": n}``, configs a model family that the
  reference checks, drawn from the seed among the window's.

Entry: ``SweepEngine(planner_mode=True).run_grid([keys])``, a one-member
plan, the planner's unit of work, so that the window ends at a config
boundary: the config in flight at the deadline completes and counts.
Set-up makes the data from the seed, builds the engine and runs one
config of each family (the kernels load, the allocator fills)."""

import itertools
import random
import time

import numpy as np

from port_bench.harness import data, stats
from port_bench.reference import cv, grid

AXES = ("flaky", "features", "prep", "balancing", "model")


def config_list(axes):
    """The configs of ``axes`` in the grid's canonical order."""
    order = {k: i for i, k in enumerate(grid.config_keys())}
    keys = itertools.product(*[axes[a] for a in AXES])
    return sorted((tuple(k) for k in keys), key=order.__getitem__)


def tree_overrides(config):
    n = int(config["n_estimators"])
    return {} if n == 100 else {"Random Forest": n, "Extra Trees": n}


def setup(run):
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    cfg, p = run.config, run.params
    study = data.study_data(cfg, run.seed)
    engine = SweepEngine(
        study.features, study.labels, study.projects, study.project_names,
        study.project_ids, max_depth=int(cfg["max_depth"]),
        tree_overrides=tree_overrides(cfg), planner_mode=True,
        seed=data.seed32(run.seed), device=run.device)
    configs = config_list(p["axes"])
    warm = {}
    for keys in configs:
        warm.setdefault(keys[4], keys)
    for keys in warm.values():
        engine.run_grid([keys])
    return {"run": run, "study": study, "engine": engine,
            "configs": configs}


def window(state, seconds, tracer):
    """Run the configs for ``seconds``; the rate is configs completed over
    the time from the start to the completion of the last. A traced run
    goes on past the deadline until its traced configs are done."""
    engine, configs = state["engine"], state["configs"]
    trace = state["run"].params.get("trace", {})
    t_from = int(trace.get("from", 0))
    t_to = t_from + int(trace.get("count", 1))
    done, failed = [], 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    t_last = t0
    i = 0
    while True:
        keys = configs[i % len(configs)]
        if i == t_from:
            tracer.start()
        res = engine.run_grid([keys]).get(keys)
        t_last = time.perf_counter()
        if res is None:
            failed += 1
        else:
            done.append((keys, res))
        i += 1
        if i == t_to:
            tracer.stop(configs=t_to - t_from)
        if t_last >= deadline and tracer.state != "on" and (
                tracer.state == "done" or not tracer.enabled):
            break
    if tracer.state == "on":
        tracer.stop(configs=i - t_from)
    return {"configs_per_s": stats.rate(len(done), t0, t_last),
            "window_s": t_last - t0, "done": done, "attempted": i,
            "failed": failed,
            "extra": {"configs": len(done), "window_s": t_last - t0}}


def release(state):
    state.pop("engine", None)


def program_counts(result, project_names):
    """[P, 3] (FP, FN, TP) of a config's result in the program's schema
    ([t_train, t_test, {project: [fp, fn, tp, p, r, f]}, total])."""
    scores = result[2]
    return np.asarray([scores[p][:3] for p in project_names], np.int64)


def sample(state, record):
    """The configs the reference checks: ``per_family`` distinct configs
    of each model family among the window's, drawn from the seed."""
    per = int(state["run"].params.get("check", {}).get("per_family", 1))
    rnd = random.Random(state["run"].seed)
    fams = {}
    for keys, _ in record["done"]:
        fams.setdefault(keys[4], [])
        if keys not in fams[keys[4]]:
            fams[keys[4]].append(keys)
    return [k for fam in sorted(fams) for k in
            rnd.sample(fams[fam], min(per, len(fams[fam])))]


def reference_counts(state, keys, lowp=False):
    run, study = state["run"], state["study"]
    n_trees = int(run.config["n_estimators"])
    return cv.config_counts(
        keys, study.features, study.labels, study.project_ids,
        len(study.project_names), seed=data.seed32(run.seed),
        device=run.device, max_depth=int(run.config["max_depth"]),
        n_trees=None if n_trees == 100 else n_trees, lowp=lowp)


def check(state, record):
    """Every completed run of the sampled configs against the reference's
    counts: the number of count cells (project x FP/FN/TP, summed over
    the configs' runs) that differ, and the configs of the window that
    gave no counts (quarantined). Both exact, so their limits are 0."""
    names = state["study"].project_names
    diff = 0
    for keys in sample(state, record):
        ref = reference_counts(state, keys)
        for k, res in record["done"]:
            if k == keys:
                diff += int((program_counts(res, names) != ref).sum())
    return {"count_cells_differing": {
                "value": diff, "limit": state["run"].params["check"]["limit"]},
            "configs_failed": {"value": record["failed"], "limit": 0}}


def control(state, record):
    """The control's reading of ``check``'s number: the reference put in
    the program's place and computed with its preprocessed features in
    bfloat16, against the float32 reference, on the same sampled configs
    (one run of each)."""
    diff = 0
    for keys in sample(state, record):
        ref = reference_counts(state, keys)
        diff += int((reference_counts(state, keys, lowp=True) != ref).sum())
    return {"count_cells_differing": diff}
