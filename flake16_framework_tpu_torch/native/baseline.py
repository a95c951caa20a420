"""The host C++ Tree SHAP baseline (``treeshap_cext.cc``) from Python: a
copy of the JAX package's ``native/baseline.py``.

``forest_shap_class0_cext`` takes the numpy oracle's contract
(``tests/ref_treeshap.py::forest_shap_class0_ref``: a list of per-tree
``(children_left, children_right, feature, threshold, value01)`` tuples),
so a caller can swap the two one for one; ``forest_trees`` makes that list
from a forest's structure of arrays. Where the JAX package's function
returns None when the module cannot be built, this one raises
``native.NativeBuildError``: it runs or raises. Imports no torch; a
port ``Forest`` is read on the CPU through ``np.asarray``."""

import numpy as np

from flake16_framework_tpu_torch import native


def forest_trees(forest):
    """The per-tree ``(left, right, feature, threshold, value01)`` tuples
    of a forest whose fields convert with ``np.asarray`` (a port
    ``Forest`` on the CPU, or the JAX package's): ids and features int32,
    thresholds and class counts widened to f64 with no rescaling."""
    fields = [np.asarray(forest.left, np.int32),
              np.asarray(forest.right, np.int32),
              np.asarray(forest.feature, np.int32),
              np.asarray(forest.threshold).astype(np.float64),
              np.asarray(forest.value).astype(np.float64)]
    return [tuple(f[t] for f in fields) for t in range(fields[0].shape[0])]


def forest_shap_class0_cext(forest_trees, x):
    """Mean class-0 SHAP [S, F] f64 over the forest, by the C++ module;
    raises ``native.NativeBuildError`` when it cannot be built. Trees are
    padded to a common node count with self-contained leaves (feature -1,
    zero cover) that the recursion never visits."""
    mod = native.load("treeshap_cext")
    t = len(forest_trees)
    m = max(tree[0].shape[0] for tree in forest_trees)
    left = np.full((t, m), -1, np.int32)
    right = np.full((t, m), -1, np.int32)
    feature = np.full((t, m), -1, np.int32)
    threshold = np.zeros((t, m), np.float64)
    value01 = np.zeros((t, m, 2), np.float64)
    for i, (le, ri, fe, th, v) in enumerate(forest_trees):
        k = le.shape[0]
        left[i, :k] = le
        right[i, :k] = ri
        feature[i, :k] = fe
        threshold[i, :k] = th
        value01[i, :k] = v
    x = np.ascontiguousarray(x, np.float64)
    s, f = x.shape
    phi = np.zeros((s, f), np.float64)
    mod.forest_shap_class0(  # ndarrays pass as buffers, no copies
        left, right, feature, threshold, value01, x, phi, t, m, s, f,
    )
    return phi
