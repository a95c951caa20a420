"""The verbs. ``scores``: the 10-fold CV sweep over the grid, written as
the reference-schema ``scores.pkl`` ({config_keys: [t_train, t_test,
scores, scores_total]}); the configs of an earlier run's ``scores.pkl``
are skipped, and a write-ahead journal beside it resumes a killed sweep at
fold granularity. ``shap``: Tree SHAP values of the two paper
configs, written as ``shap.pkl`` (a list of two float32 [N, F] arrays in
``config.SHAP_CONFIGS`` order). ``shap_grid``: the SHAP values of every
config of the grid (or of a list), path-dependent, interventional or
interaction values, of the first ``n_explain`` samples."""

import json
import os
import pickle
import sys
import time
import zlib

import numpy as np
import torch

from flake16_framework_tpu_torch import config as cfg, rng
from flake16_framework_tpu_torch.constants import (
    LOPO_SCORES_FILE, SCORES_FILE, SHAP_FILE, TESTS_FILE,
)
from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
from flake16_framework_tpu_torch.device import resolve
from flake16_framework_tpu_torch.ops import trees, treeshap
from flake16_framework_tpu_torch.ops.preprocess import fit_preprocess, transform
from flake16_framework_tpu_torch.ops.resample import resample
from flake16_framework_tpu_torch.parallel.planner import plan_explain_grid
from flake16_framework_tpu_torch.parallel.sweep import SEED, SweepEngine
from flake16_framework_tpu_torch.resilience import inject as rinject
from flake16_framework_tpu_torch.resilience import journal as rjournal
from flake16_framework_tpu_torch.resilience import quarantine as rquarantine
from flake16_framework_tpu_torch.utils.atomic import atomic_write_bytes

SHAP_MODES = ("path", "interventional", "interaction")


def _load_ledger(out_file, warn_out=sys.stderr):
    """The pickle checkpoint as a resume source. A torn or corrupt pickle,
    or one that is not a dict, WARNS and restarts all configs rather than
    aborting the sweep; entries that do not carry the reference 4-element
    value schema are dropped individually, with a warning."""
    if not os.path.exists(out_file):
        return {}
    try:
        with open(out_file, "rb") as fd:
            ledger = pickle.load(fd)
    except (OSError, EOFError, pickle.UnpicklingError, AttributeError,
            ImportError, IndexError, ValueError) as e:
        warn_out.write(
            f"warning: checkpoint ledger {out_file} unreadable "
            f"({type(e).__name__}: {e}); restarting all configs\n")
        return {}
    if not isinstance(ledger, dict):
        warn_out.write(
            f"warning: checkpoint ledger {out_file} is not a dict "
            f"({type(ledger).__name__}); restarting all configs\n")
        return {}
    bad = [k for k, v in ledger.items()
           if not (isinstance(v, (list, tuple)) and len(v) == 4)]
    for k in bad:
        del ledger[k]
    if bad:
        warn_out.write(
            f"warning: dropped {len(bad)} malformed ledger entr"
            f"{'y' if len(bad) == 1 else 'ies'} from {out_file}; "
            f"those configs restart\n")
    return ledger


def _journal_fingerprint(engine, *, cv, max_depth, tree_overrides):
    """The run identity a journal must match to be replayed: everything
    that changes fold keys, fold membership, or per-fold counts (the JAX
    package's keys, so either package replays the other's journal). The
    data CRCs are over the host arrays: int32 labels, float32 features."""
    return {
        "schema": rjournal.SCHEMA,
        "seed": SEED,
        "cv": cv,
        "n_folds": engine.n_folds,
        "max_depth": max_depth,
        "grower": trees.ensemble_grower(engine.grower),
        "tree_overrides": sorted((tree_overrides or {}).items()),
        "data": [list(engine.features.shape),
                 zlib.crc32(engine.labels_host.tobytes()),
                 zlib.crc32(engine.features.tobytes())],
    }


def _dump(obj, path):
    atomic_write_bytes(path, pickle.dumps(obj))


def _write_timing_meta(out_file, amortized_configs, fused_configs):
    """Timing provenance beside the pickle, ``<out_file>.meta.json``, as the
    JAX package writes it: the configs whose T_TRAIN/T_TEST a plan
    amortized over its members (``batch_amortized``) and those whose
    combined fit-and-predict wall is in T_TRAIN with T_TEST = 0.0
    (``fused_combined``); every other config carries its own clocks. The
    pickle keeps the reference's 4-element values, whose readers unpack
    them strictly. Merges with the file an earlier run left, so a config
    marked by any contributing run stays marked."""
    meta_file = out_file + ".meta.json"
    known, known_fused = set(), set()
    if os.path.exists(meta_file):
        with open(meta_file) as fd:
            prev = json.load(fd)
        known = {tuple(k) for k in prev["batch_amortized"]}
        known_fused = {tuple(k) for k in prev.get("fused_combined", [])}
    merged = sorted(known | {tuple(k) for k in amortized_configs})
    merged_fused = sorted(known_fused | {tuple(k) for k in fused_configs})
    atomic_write_bytes(meta_file, json.dumps({
        "schema": "flake16-timing-meta-v1",
        "note": ("configs under batch_amortized have batch-amortized "
                 "T_TRAIN/T_TEST (mesh batch wall divided evenly); "
                 "configs under fused_combined ran as one fused "
                 "dispatch (combined wall in T_TRAIN, T_TEST=0.0); "
                 "all other configs carry true per-config clocks"),
        "batch_amortized": [list(k) for k in merged],
        "fused_combined": [list(k) for k in merged_fused],
    }, indent=1).encode())


def write_scores(tests_file=TESTS_FILE, out_file=None, *,
                 max_depth=48, tree_overrides=None, configs=None,
                 progress_out=sys.stdout, cv="stratified", device=None,
                 fused=False, planner=False, dispatch_trees=None,
                 dispatch_folds=None):
    """Run the sweep over ``configs`` (key tuples, as the JAX package's
    ``write_scores`` takes them; default the whole grid) and pickle the
    scores. ``cv="lopo"`` runs leave-one-project-out CV; the default
    ``out_file`` follows the scheme (``scores.pkl`` or
    ``scores-lopo.pkl``), so a LOPO run never resumes from a stratified
    ledger. Runs on ``cuda`` unless ``device`` says otherwise.

    ``planner=True`` runs the configs as family plans and ``fused=True``
    each config through the fold-batched fit (``SweepEngine``): the same
    scores, with combined (and, for plans, amortized) clocks, which
    ``<out_file>.meta.json`` records (``_write_timing_meta``, written on
    every run). ``dispatch_trees``/``dispatch_folds`` bound the trees and
    folds those paths grow as one batch; they change no result.

    Crash tolerance: a write-ahead journal rides beside the pickle at
    ``<out_file>.journal`` — fsync'd,
    checksummed records at fold granularity. A killed run resumes exactly
    its unfinished (config, fold) pairs with the same keys, so the final
    pickle's scores equal an uninterrupted run's; the journal is deleted
    once the final pickle is on disk. A second live resumer fails fast
    with ``resilience.JournalLocked``. Every config runs under the
    dispatch guard; configs that exhaust their attempts are left out of
    the pickle, recorded in ``<out_file>.quarantine.json``, and
    ``QuarantinedConfigs`` (exit code 23) is raised once everything is
    on disk."""
    if out_file is None:
        out_file = SCORES_FILE if cv == "stratified" else LOPO_SCORES_FILE
    device = resolve(device)
    feats, labels, projects, names, pids = tests_to_arrays(
        load_tests(tests_file))
    engine = SweepEngine(feats, labels, projects, names, pids,
                         max_depth=max_depth, tree_overrides=tree_overrides,
                         cv=cv, device=device, fused=fused,
                         planner_mode=planner, dispatch_trees=dispatch_trees,
                         dispatch_folds=dispatch_folds)
    ledger = _load_ledger(out_file)
    fp = _journal_fingerprint(engine, cv=cv, max_depth=max_depth,
                              tree_overrides=tree_overrides)
    jr = rjournal.SweepJournal.open(rjournal.journal_path(out_file), fp,
                                    plan=rinject.plan_from_env())
    if jr.ledger or jr.partial:
        progress_out.write(
            f"journal: replayed {len(jr.ledger)} completed config(s) "
            f"and {sum(len(v) for v in jr.partial.values())} partial "
            f"fold(s) from {rjournal.journal_path(out_file)}\n")
    # The journal wins where the two disagree: the pickle is written only
    # when a run ends.
    ledger.update(jr.ledger)
    engine.journal = jr
    t0 = time.time()

    def progress(i, total, keys, live_scores):
        progress_out.write(
            f"[{i}/{total}] {', '.join(keys)} ({time.time() - t0:.1f}s "
            f"elapsed)\n")

    try:
        scores = engine.run_grid(configs, ledger=ledger, progress=progress)
    except BaseException:
        # The journal stays on disk (it is the resume state); its fd and
        # lock are released for the next run.
        jr.close(remove=False)
        raise
    _dump(scores, out_file)
    _write_timing_meta(out_file, engine.amortized_configs,
                       engine.fused_configs)
    # The durable pickle supersedes the journal. Quarantined configs are
    # absent from both, so the next run re-attempts exactly them.
    jr.finalize()
    progress_out.write(
        f"journal: {jr.n_appends} appends in {jr.append_wall_s:.6f} s "
        f"of {time.time() - t0:.3f} s\n")
    rquarantine.update_sidecar(rquarantine.sidecar_path(out_file),
                               engine.quarantined, completed=scores.keys())
    if engine.quarantined:
        for keys, rec in sorted(engine.quarantined.items()):
            progress_out.write(
                f"QUARANTINED {'/'.join(keys)} [{rec['fault_class']}] "
                f"after {len(rec['attempts'])} attempt(s)\n")
        raise rquarantine.QuarantinedConfigs(engine.quarantined,
                                             scores=scores)
    return scores


def fit_shap_model(config_keys, feats, labels_raw, *, max_depth=48,
                   tree_overrides=None, device=None, key=None):
    """The SHAP stage's fit (reference get_shap): preprocess the full
    matrix, balance it, fit the config's forest on the balanced set with
    node capacity 4N. ``split(key)`` gives the resampler's key and the
    forest's; ``key`` defaults to ``PRNGKey(0)``, the JAX package's staged
    path. Returns (xp [N, F'] the preprocessed samples, mu, W, forest),
    with xp = transform(x, mu, W); the scoring service's registry keeps
    mu and W."""
    dev = resolve(device)
    fl, cols, prep, bal, spec = cfg.resolve_config(config_keys)
    if tree_overrides and spec.name in tree_overrides:
        spec = type(spec)(spec.name, tree_overrides[spec.name],
                          spec.bootstrap, spec.random_splits,
                          spec.sqrt_features)
    x = torch.as_tensor(np.asarray(feats[:, list(cols)], dtype=np.float32),
                        device=dev)
    y = torch.as_tensor(np.asarray(labels_raw) == fl, device=dev)
    n = x.shape[0]
    mu, wmat = fit_preprocess(x, prep)
    xp = transform(x, mu, wmat)
    key = rng.prng_key(0, dev) if key is None else key.to(dev)
    kb, kf = rng.split(key).unbind(0)
    xs, ys, ws = resample(xp, y, torch.ones(n, dtype=torch.float32,
                                            device=dev), bal, kb, 2 * n)
    fit = trees.fit_forest_hist if trees.hist_tier_default(spec.n_trees) \
        else trees.fit_forest
    forest = fit(xs, ys, ws, kf, n_trees=spec.n_trees,
                 bootstrap=spec.bootstrap, random_splits=spec.random_splits,
                 sqrt_features=spec.sqrt_features, max_depth=max_depth,
                 max_nodes=4 * n)
    return xp, mu, wmat, forest


def shap_for_config(config_keys, feats, labels_raw, *, mode="path",
                    n_explain=None, n_background=0, key=None, max_depth=48,
                    tree_overrides=None, device=None):
    """One SHAP config: fit (``fit_shap_model`` with ``key``), then
    explain the first ``n_explain`` preprocessed samples (all by default)
    by ``mode``: "path" (path-dependent Tree SHAP on the unit kernel,
    [S, F']), "interventional" (against the first ``n_background``
    preprocessed samples, [S, F']) or "interaction" ([S, F', F']).
    Returns {"values": f32 numpy, "forest", "x": the preprocessed samples
    [N, F'], "fit_s", "explain_s": the two stages' walls in seconds}."""
    if mode not in SHAP_MODES:
        raise ValueError(f"mode must be path|interventional|interaction, "
                         f"got {mode!r}")
    if mode == "interventional" and not n_background:
        raise ValueError("interventional mode needs n_background > 0")
    dev = resolve(device)
    t0 = time.time()
    xp, _, _, forest = fit_shap_model(config_keys, feats, labels_raw,
                                 max_depth=max_depth,
                                 tree_overrides=tree_overrides, device=dev,
                                 key=key)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fit_s = time.time() - t0
    t0 = time.time()
    xe = xp[:n_explain]
    if mode == "interventional":
        values = treeshap.forest_shap_interventional(forest, xe,
                                                     xp[:n_background])
    elif mode == "interaction":
        values = treeshap.forest_shap_interactions(forest, xe)
    else:
        values = treeshap.forest_shap_class0(forest, xe)
    values = values.cpu().numpy()
    return {"values": values, "forest": forest, "x": xp, "fit_s": fit_s,
            "explain_s": time.time() - t0}


def write_shap(tests_file=TESTS_FILE, out_file=SHAP_FILE, *, max_depth=48,
               tree_overrides=None, device=None):
    """The two paper configs (``config.SHAP_CONFIGS``): pickles their
    values to ``out_file`` and returns the per-config results of
    ``shap_for_config``. Runs on ``cuda`` unless ``device`` says
    otherwise."""
    device = resolve(device)
    feats, labels, _, _, _ = tests_to_arrays(load_tests(tests_file))
    results = [shap_for_config(keys, feats, labels, max_depth=max_depth,
                               tree_overrides=tree_overrides, device=device)
               for keys in cfg.SHAP_CONFIGS]
    _dump([r["values"] for r in results], out_file)
    return results


def shap_grid(tests_file=TESTS_FILE, out_file=None, *, mode="path",
              n_explain=64, n_background=32, max_depth=48,
              tree_overrides=None, seed=0, configs=None, arrays=None,
              device=None, progress_out=sys.stdout):
    """SHAP values of every config of the grid (or of ``configs``), as
    the JAX package's ``shap_grid`` computes them: the configs grouped
    into family plans (``plan_explain_grid``), and each member run in
    turn through ``shap_for_config`` with the key ``fold_in(PRNGKey(seed),
    canonical grid index)``, explaining its first ``n_explain``
    preprocessed samples by ``mode`` (path|interventional|interaction;
    interventional against the first ``n_background``); both counts are
    clipped to N. ``arrays`` = (feats, labels_raw) stands in for the tests
    file. Runs on ``cuda`` unless ``device`` says otherwise.

    Returns {config keys joined by "/": f32 values} in plan order; with
    ``out_file`` it pickles {"mode", "n_explain", "n_background" (0 unless
    interventional), "values"}. Writes one line a member to
    ``progress_out``: its keys and its fit and explain walls."""
    device = resolve(device)
    if arrays is not None:
        feats, labels = arrays[0], arrays[1]
    else:
        feats, labels, _, _, _ = tests_to_arrays(load_tests(tests_file))
    n = feats.shape[0]
    n_explain = min(int(n_explain), n)
    n_background = min(int(n_background), n)
    config_list = [tuple(k) for k in (configs or cfg.iter_config_keys())]
    plans = plan_explain_grid(
        config_list, n=n, n_folds=0, n_explain=n_explain,
        tree_overrides=tree_overrides)
    total = sum(len(p.configs) for p in plans)
    base = rng.prng_key(seed, device)
    values = {}
    t0 = time.time()
    for plan in plans:
        for keys, index in zip(plan.configs, plan.indices):
            res = shap_for_config(
                keys, feats, labels, mode=mode, n_explain=n_explain,
                n_background=n_background, key=rng.fold_in(base, index),
                max_depth=max_depth, tree_overrides=tree_overrides,
                device=device)
            values["/".join(keys)] = res["values"]
            progress_out.write(
                f"[{len(values)}/{total}] {', '.join(keys)} "
                f"(fit {res['fit_s']:.3f} s, explain "
                f"{res['explain_s']:.3f} s; {time.time() - t0:.1f}s "
                f"elapsed)\n")
    if out_file is not None:
        _dump({"mode": mode, "n_explain": n_explain,
               "n_background": n_background if mode == "interventional"
               else 0, "values": values}, out_file)
    return values
