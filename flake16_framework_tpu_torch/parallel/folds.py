"""Host-side replication of ``StratifiedKFold(10, shuffle=True, rs=0)``
(a copy of the JAX package's): sklearn's assignment algorithm with numpy's
MT19937, returned as 0/1 membership masks so every fold has one shape; and
the leave-one-project-out masks."""

import numpy as np

N_SPLITS = 10


def stratified_fold_ids(labels, n_splits=N_SPLITS, seed=0):
    """Per-sample test-fold assignment, identical to sklearn's
    StratifiedKFold(n_splits, shuffle=True, random_state=seed)."""
    y = np.asarray(labels)
    rng = np.random.RandomState(seed)

    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]

    n_classes = len(y_idx)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes)
        for i in range(n_splits)
    ])

    test_folds = np.empty(len(y), dtype=np.int32)
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class

    return test_folds


def fold_masks(labels, n_splits=N_SPLITS, seed=0):
    """(train_mask [n_splits, N], test_mask [n_splits, N]) float32 0/1 masks."""
    test_folds = stratified_fold_ids(labels, n_splits, seed)
    test = (test_folds[None, :] == np.arange(n_splits)[:, None])
    return (~test).astype(np.float32), test.astype(np.float32)


def lopo_fold_masks(project_ids, n_projects):
    """Leave-one-project-out CV masks: fold p trains on every project but
    p and tests on p. The same (train [P, N], test [P, N]) float32 0/1
    contract as ``fold_masks``."""
    pids = np.asarray(project_ids)
    test = (pids[None, :] == np.arange(n_projects)[:, None])
    return (~test).astype(np.float32), test.astype(np.float32)
