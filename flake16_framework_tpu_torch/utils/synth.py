"""Synthetic ``tests.json`` generation (a copy of the JAX package's, numpy
only): 26 projects, the 16 Flake16 features with count-like heavy-tailed
distributions, heavy class imbalance and a weak learnable signal.

Schema: ``{proj: {nid: [req_runs, label, *16 features]}}``.
"""

import json

import numpy as np

from flake16_framework_tpu_torch.constants import NON_FLAKY, OD_FLAKY, FLAKY
from flake16_framework_tpu_torch.utils.atomic import atomic_write_bytes


def make_dataset(n_tests=2000, n_projects=26, nod_frac=0.06, od_frac=0.04,
                 seed=0, nod_bump=0.8, od_bump=0.5, noise_sigma=0.4):
    """Return (features [N,16] float, labels [N] int, project_ids [N] int)."""
    rng = np.random.RandomState(seed)

    labels = rng.choice(
        [NON_FLAKY, OD_FLAKY, FLAKY], size=n_tests,
        p=[1.0 - nod_frac - od_frac, od_frac, nod_frac]
    )
    project_ids = np.sort(rng.randint(0, n_projects, size=n_tests))

    base = rng.lognormal(mean=3.0, sigma=1.2, size=(n_tests, 16))
    scale = np.array([200, 50, 150, 0.01, 30, 20, 5, 1, 1e4,
                      1, 3, 2, 50, 2, 10, 1.0])
    feats = base * scale[None, :]

    bump = 1.0 + nod_bump * (labels == FLAKY) + od_bump * (labels == OD_FLAKY)
    noise = rng.lognormal(0.0, noise_sigma, size=(n_tests, 16))
    feats = feats * (bump[:, None] * noise)

    int_cols = [0, 1, 2, 4, 5, 6, 7, 9, 10, 11, 13, 14]
    feats[:, int_cols] = np.round(feats[:, int_cols])
    feats[:, 8] = np.round(feats[:, 8])  # Max. Memory in KB
    feats[:, 15] = np.clip(100.0 - feats[:, 15], 0, 100)  # Maintainability index

    return feats, labels.astype(np.int32), project_ids.astype(np.int32)


def make_tests_json(path=None, n_tests=2000, n_projects=26, seed=0,
                    names=None):
    """Write (or return) a reference-schema tests.json. ``names`` replaces
    the synthetic ``projectNN`` keys (for example with the subject
    registry's names, so that the figures verb's subject join works on
    synthetic data)."""
    if names is not None and len(names) != n_projects:
        raise ValueError(f"{len(names)} names for {n_projects} projects")
    feats, labels, project_ids = make_dataset(
        n_tests=n_tests, n_projects=n_projects, seed=seed
    )
    rng = np.random.RandomState(seed + 1)

    tests = {}
    for pid in range(n_projects):
        rows = np.flatnonzero(project_ids == pid)
        if rows.size == 0:
            continue
        proj = f"project{pid:02d}" if names is None else names[pid]
        tests_proj = {}
        for j, r in enumerate(rows):
            req_runs = int(rng.randint(1, 2500)) if labels[r] != NON_FLAKY else 0
            tests_proj[f"tests/test_{proj}.py::test_{j:04d}"] = [
                req_runs, int(labels[r]), *[float(x) for x in feats[r]]
            ]
        tests[proj] = tests_proj

    if path is not None:
        atomic_write_bytes(path, json.dumps(tests, indent=4).encode())

    return tests
