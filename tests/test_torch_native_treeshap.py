"""The port's host C++ Tree SHAP baseline (``native/treeshap_cext.cc``
through ``native/baseline.py``): bitwise against the JAX package's module
on the same trees, within rtol 1e-9 / atol 1e-11 of the numpy oracle
(``tests/ref_treeshap.py``, the grade of ``tests/test_native_treeshap.py``)
on small sklearn forests, local accuracy within 1e-9, and within atol
1e-5 of the port's f32 Tree SHAP (K2's plain version on the CPU) on a
port forest, the grade the JAX package holds its f64 oracle to against
its f32 engine. A failed build raises."""

import ast
import sys

import numpy as np
import pytest
import torch
from sklearn.ensemble import RandomForestClassifier
from sklearn.tree import DecisionTreeClassifier

from flake16_framework_tpu.native.baseline import (
    forest_shap_class0_cext as jax_cext,
)
from flake16_framework_tpu_torch import native, rng
from flake16_framework_tpu_torch.native import baseline
from flake16_framework_tpu_torch.ops import trees as ttrees
from flake16_framework_tpu_torch.ops import treeshap as tshap
from ref_treeshap import forest_shap_class0_ref, sklearn_forest_trees


def _sklearn_forest(n=250, f=10, trees=8, depth=None, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, f)
    y = (x[:, 0] - x[:, 3] + 0.5 * rs.randn(n)) > 0
    if trees == 1:
        m = DecisionTreeClassifier(random_state=0, max_depth=depth)
    else:
        m = RandomForestClassifier(n_estimators=trees, random_state=0,
                                   max_depth=depth)
    return m.fit(x, y), x


# The JAX test's cases: a deep tree over few features (repeat splits on a
# path), a shallow forest, a deep one.
CASES = [pytest.param(1, None, 4, id="dt-deep-4f"),
         pytest.param(6, 6, 10, id="rf-depth6"),
         pytest.param(10, None, 10, id="rf-deep")]


@pytest.mark.parametrize("trees,depth,f", CASES)
def test_cext_equals_jax_module_and_oracle(trees, depth, f):
    m, x = _sklearn_forest(f=f, trees=trees, depth=depth, seed=1)
    ft = sklearn_forest_trees(m)
    xq = x[:64]
    got = baseline.forest_shap_class0_cext(ft, xq)
    want = jax_cext(ft, xq)
    assert want is not None, "the JAX package's module did not build"
    assert got.dtype == np.float64 and got.shape == (64, f)
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(got, forest_shap_class0_ref(ft, xq),
                               rtol=1e-9, atol=1e-11)


def test_cext_local_accuracy():
    m, x = _sklearn_forest(n=300, trees=10, seed=2)
    ft = sklearn_forest_trees(m)
    xq = x[:80]
    phi = baseline.forest_shap_class0_cext(ft, xq)
    base = np.mean([v[0, 0] / max(v[0].sum(), 1e-30) for *_, v in ft])
    np.testing.assert_allclose(phi.sum(1),
                               m.predict_proba(xq)[:, 0] - base, atol=1e-9)


@pytest.mark.parametrize("random_splits", [False, True], ids=["rf", "et"])
def test_cext_against_the_ports_tree_shap(random_splits):
    """A port forest (class counts in f32) widened to f64 with no
    rescaling (``baseline.forest_trees``): the C++ values within atol 1e-5
    of the port's f32 engine, and bitwise the JAX module's."""
    rs = np.random.RandomState(5)
    x = rs.randn(150, 8).astype(np.float32)
    y = (x[:, 1] - x[:, 3] + 0.4 * rs.randn(150)) > 0
    forest = ttrees.fit_forest_hist(
        torch.from_numpy(x), torch.from_numpy(y), torch.ones(150),
        rng.prng_key(2), n_trees=5, bootstrap=not random_splits,
        random_splits=random_splits, sqrt_features=True, max_depth=12,
        max_nodes=512)
    xq = rs.randn(20, 8).astype(np.float32)
    ft = baseline.forest_trees(forest)
    assert ft[0][3].dtype == np.float64 and ft[0][4].dtype == np.float64
    np.testing.assert_array_equal(ft[0][4], forest.value[0].double().numpy())
    got = baseline.forest_shap_class0_cext(ft, xq)
    ours = tshap.forest_shap_class0(forest, torch.from_numpy(xq))
    np.testing.assert_allclose(got, ours.numpy(), rtol=0, atol=1e-5)
    assert got.tobytes() == jax_cext(ft, xq).tobytes()


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_compile_cmd", lambda src, out: [
        sys.executable, "-c",
        "import sys; sys.stderr.write('boom: no Python.h'); sys.exit(2)"])
    m, x = _sklearn_forest(trees=2, depth=3)
    with pytest.raises(native.NativeBuildError,
                       match="(?s)treeshap_cext.cc.*exit 2.*boom"):
        baseline.forest_shap_class0_cext(sklearn_forest_trees(m), x[:4])
    assert list(tmp_path.iterdir()) == []


def test_baseline_imports_neither_torch_nor_jax():
    tree = ast.parse(open(baseline.__file__).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert not any(n.split(".")[0] in ("torch", "jax") or
                   n.startswith("flake16_framework_tpu.") or
                   n == "flake16_framework_tpu" for n in names), names
