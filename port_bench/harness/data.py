"""The inputs, made from the run's seed and handed to the program and the
reference alike: a copy of the port's synthetic ``tests.json`` generator
(``utils/synth.py::make_dataset``), 26 projects and the 16 Flake16
features with count-like heavy-tailed distributions, heavy class
imbalance and a weak learnable signal."""

from typing import NamedTuple

import numpy as np

NON_FLAKY, OD_FLAKY, FLAKY = 0, 1, 2


def seed32(seed):
    """The run's seed as the 32-bit seed numpy's generator and the
    program's threefry keys take (both refuse wider ones)."""
    return int(seed) % (1 << 32)


def make_dataset(n_tests=2000, n_projects=26, nod_frac=0.06, od_frac=0.04,
                 seed=0, nod_bump=0.8, od_bump=0.5, noise_sigma=0.4):
    """(features [N, 16] float, labels [N] int, project_ids [N] int)."""
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
    feats[:, 15] = np.clip(100.0 - feats[:, 15], 0, 100)  # Maintainability

    return feats, labels.astype(np.int32), project_ids.astype(np.int32)


class Study(NamedTuple):
    """One study data set in the arrays the sweep takes (the port's
    ``data.tests_to_arrays`` of the generated ``tests.json``)."""

    features: np.ndarray       # [N, 16] float64
    labels: np.ndarray         # [N] int32
    projects: np.ndarray       # [N] project name of each test
    project_names: list        # first-seen order
    project_ids: np.ndarray    # [N] int32 index into project_names


def study_data(config, seed):
    """The configuration's data set (``n_tests``, ``n_projects``) from the
    run's seed. Projects are named ``projectNN`` as the generator's
    ``tests.json`` names them; a project that drew no test is absent."""
    feats, labels, pids = make_dataset(
        n_tests=config["n_tests"], n_projects=config["n_projects"],
        seed=seed32(seed))
    present = list(dict.fromkeys(pids.tolist()))
    index = {p: i for i, p in enumerate(present)}
    names = [f"project{p:02d}" for p in present]
    ids = np.asarray([index[p] for p in pids.tolist()], np.int32)
    projects = np.asarray([names[i] for i in ids])
    return Study(feats.astype(np.float64), labels, projects, names, ids)
