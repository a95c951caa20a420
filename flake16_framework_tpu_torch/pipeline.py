"""The ``scores`` verb: the 10-fold CV sweep over the grid, written as the
reference-schema ``scores.pkl`` ({config_keys: [t_train, t_test, scores,
scores_total]}). A partial ``scores.pkl`` is reloaded and its configs are
skipped."""

import os
import pickle
import sys
import time

from flake16_framework_tpu_torch.constants import SCORES_FILE, TESTS_FILE
from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
from flake16_framework_tpu_torch.device import resolve
from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
from flake16_framework_tpu_torch.utils.synth import atomic_write_bytes

CHECKPOINT_EVERY = 12  # configs between partial ``scores.pkl`` dumps


def _load_ledger(out_file):
    if not os.path.exists(out_file):
        return {}
    with open(out_file, "rb") as fd:
        ledger = pickle.load(fd)
    return {k: v for k, v in ledger.items()
            if isinstance(v, (list, tuple)) and len(v) == 4}


def _dump(obj, path):
    atomic_write_bytes(path, pickle.dumps(obj))


def write_scores(tests_file=TESTS_FILE, out_file=SCORES_FILE, *,
                 max_depth=48, tree_overrides=None, configs=None,
                 progress_out=sys.stdout, device=None):
    """Run the sweep over ``configs`` (key tuples, as the JAX package's
    ``write_scores`` takes them; default the whole grid) and pickle the
    scores. Runs on ``cuda`` unless ``device`` says otherwise. Decision
    Tree configs raise ``NotImplementedError`` before anything runs."""
    device = resolve(device)
    feats, labels, projects, names, pids = tests_to_arrays(
        load_tests(tests_file))
    engine = SweepEngine(feats, labels, projects, names, pids,
                         max_depth=max_depth, tree_overrides=tree_overrides,
                         device=device)
    ledger = _load_ledger(out_file)
    t0 = time.time()

    def progress(i, total, keys, live_scores):
        progress_out.write(
            f"[{i}/{total}] {', '.join(keys)} ({time.time() - t0:.1f}s "
            f"elapsed)\n")
        if i % CHECKPOINT_EVERY == 0:
            _dump(live_scores, out_file)

    scores = engine.run_grid(configs, ledger=ledger, progress=progress)
    _dump(scores, out_file)
    return scores
