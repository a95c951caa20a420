"""Dataset loading: ``tests.json`` -> fixed-shape numpy arrays (a copy of
the JAX package's loader). Projects in file order, then tests in file
order; features are each test's tuple minus (req_runs, label)."""

import json

import numpy as np

from flake16_framework_tpu_torch.constants import N_FEATURES


def load_tests(tests_file):
    with open(tests_file, "r") as fd:
        return json.load(fd)


def tests_to_arrays(tests):
    """tests dict -> (features [N,16] f64, labels_raw [N] i32, projects [N] str,
    project_names list, project_ids [N] i32)."""
    features, labels, projects = [], [], []

    for proj, tests_proj in tests.items():
        projects += [proj] * len(tests_proj)

        for (_, label_nid, *features_nid) in tests_proj.values():
            features.append(features_nid)
            labels.append(label_nid)

    features = np.asarray(features, dtype=np.float64).reshape(-1, N_FEATURES)
    labels = np.asarray(labels, dtype=np.int32)
    projects = np.asarray(projects)

    project_names = list(dict.fromkeys(projects.tolist()))
    name_to_id = {p: i for i, p in enumerate(project_names)}
    project_ids = np.asarray([name_to_id[p] for p in projects], dtype=np.int32)

    return features, labels, projects, project_names, project_ids
