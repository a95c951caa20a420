"""What ``tune --probe`` reads of the JAX package's ``bench.py``, copied:
the six probe configs (``CONFIGS``, all three model families), the data
maker (``make_data``, seed 7) and the CPU-fallback probe size
(``FB_N_TESTS``/``FB_N_TREES`` and their ``BENCH_FB_*`` environment
reads), which is ``tune``'s default ``--n``/``--trees``. Not a port of
the benchmark: the port's benchmark is not built yet (ROADMAP.md §A 2).
"""

import os

SEED = 7

FB_N_TESTS = int(os.environ.get("BENCH_FB_N_TESTS", "400"))
FB_N_TREES = int(os.environ.get("BENCH_FB_N_TREES", "25"))

# The probe configs (the reference's first three paper configs plus
# family coverage).
CONFIGS = [
    ("NOD", "Flake16", "None", "None", "Decision Tree"),
    ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
    ("OD", "Flake16", "PCA", "SMOTE Tomek", "Extra Trees"),
    ("NOD", "Flake16", "Scaling", "ENN", "Extra Trees"),
    ("OD", "Flake16", "None", "Tomek Links", "Decision Tree"),
    ("OD", "FlakeFlagger", "Scaling", "SMOTE", "Random Forest"),
]


def make_data(n_tests):
    """(features, labels, project names a row, the 26 names, project ids)
    of the synthetic dataset at ``n_tests`` rows, seed ``SEED``."""
    import numpy as np

    from flake16_framework_tpu_torch.utils.synth import make_dataset

    feats, labels, pids = make_dataset(n_tests=n_tests, seed=SEED)
    names = [f"project{p:02d}" for p in range(26)]
    projects = np.array([names[p] for p in pids])
    return feats, labels, projects, names, pids
