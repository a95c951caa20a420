"""The port's Tree SHAP against the JAX package's on the same inputs.
Grades, per test: the plain unit against the Pallas kernel (interpreted)
and the XLA unit at rtol 1e-5, atol 1e-6; compacted rows bitwise except
z and scale (rtol 1e-6); work-item packing equal; forest SHAP values and
E[p0] at atol 1e-6; local accuracy at atol 1e-6; ``write_shap`` at
atol 1e-6."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu import pipeline as jpipe
from flake16_framework_tpu.ops import trees as jtrees
from flake16_framework_tpu.ops import treeshap as jshap
from flake16_framework_tpu.utils.synth import make_tests_json
from flake16_framework_tpu_torch import __main__ as tmain
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch.kernels import treeshap_unit as tunit
from flake16_framework_tpu_torch.ops import trees as ttrees
from flake16_framework_tpu_torch.ops import treeshap as tshap
from flake16_framework_tpu_torch.weights import forest_from_numpy


@pytest.fixture(autouse=True)
def _jax_x64_off():
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    with jax.enable_x64(False):
        yield


def _bucket(r, cap, n_feat, seed):
    """A packed bucket: unique fids per row, u in [0, cap] (dead rows and
    one-slot rows included), intervals open on either side or both."""
    rs = np.random.RandomState(seed)
    fid = np.stack([rs.permutation(n_feat)[:cap] for _ in range(r)])
    u = rs.randint(0, cap + 1, size=r)
    u[:2] = (0, 1)
    z = rs.uniform(0.05, 1.0, size=(r, cap))
    thr = np.sort(rs.randn(r, cap, 2), -1)
    lo = np.where(rs.rand(r, cap) < 0.4, -jshap._BIG, thr[..., 0])
    hi = np.where(rs.rand(r, cap) < 0.4, jshap._BIG, thr[..., 1])
    scale = rs.rand(r)
    return (fid.astype(np.int32), z.astype(np.float32),
            lo.astype(np.float32), hi.astype(np.float32),
            u.astype(np.int32), scale.astype(np.float32))


@pytest.mark.parametrize("cap,n_feat", [(4, 16), (7, 7), (16, 16)])
def test_unit_plain_matches_pallas_and_xla(cap, n_feat):
    args = _bucket(16, cap, n_feat, seed=cap)
    x = np.random.RandomState(cap + 1).randn(37, n_feat).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (*args, x)]
    pallas = np.asarray(jshap._unit_shap_pallas(*jargs, interpret=True))
    xla = np.asarray(jshap._unit_shap_xla(*jargs))
    got = tunit.unit_shap(*[torch.from_numpy(a) for a in (*args, x)]).numpy()
    assert got.shape == (n_feat, 37)
    for want in (pallas, xla):
        np.testing.assert_allclose(got, want.sum(0)[:n_feat, :37],
                                   rtol=1e-5, atol=1e-6)
    assert np.abs(got).max() > 1e-3


def test_unit_plain_batches_rows(monkeypatch):
    """The plain unit over more work items than one of its row batches
    (PLAIN_ROWS cut to 5, R = 24 with a partial last batch) against the
    XLA unit; rtol 1e-5, atol 1e-6."""
    monkeypatch.setattr(tunit, "PLAIN_ROWS", 5)
    args = _bucket(24, 8, 16, seed=11)
    x = np.random.RandomState(12).randn(29, 16).astype(np.float32)
    want = np.asarray(jshap._unit_shap_xla(
        *[jnp.asarray(a) for a in (*args, x)])).sum(0)[:16, :29]
    got = tunit.unit_shap(*[torch.from_numpy(a) for a in (*args, x)]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(got).max() > 1e-3


def _data(n=160, f=16, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, f).astype(np.float32)
    y = (x[:, 0] - x[:, 1 % f] + 0.5 * rs.randn(n)) > 0.5
    return x, y


MODELS = {"rf": dict(bootstrap=True, random_splits=False),
          "et": dict(bootstrap=False, random_splits=True)}


def _forests(model, f, seed=0, n_trees=4, max_depth=8):
    x, y = _data(f=f, seed=seed)
    jf = jtrees.fit_forest_hist(jnp.asarray(x), jnp.asarray(y),
                                jnp.ones(x.shape[0]), jax.random.PRNGKey(seed),
                                n_trees=n_trees, sqrt_features=True,
                                max_depth=max_depth, max_nodes=4 * x.shape[0],
                                **MODELS[model])
    tf = forest_from_numpy(jtrees.Forest(*[np.asarray(a) for a in jf]),
                           device="cpu")
    return jf, tf


@pytest.mark.parametrize("model", ["rf", "et"])
def test_compact_paths_matches_jax(model):
    jf, tf = _forests(model, 16, seed=1)
    want = jax.device_get(jshap._compact_paths(jf, depth=8, n_features=16))
    got = tshap.compact_paths(tf, 8, 16)
    assert set(got) == set(want)
    for k in ("fid", "u", "lo", "hi", "valid"):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    for k in ("z", "scale"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6)
    paths = tshap.extract_paths(tf, 8)
    one = jshap.extract_paths(*(a[0] for a in jf[:5]), 8)
    for k in ("sf", "sthr", "sratio", "sleft", "svalid", "leaf_p0",
              "leaf_ok", "leaf_cover_frac"):
        np.testing.assert_array_equal(paths[k][0].numpy(), np.asarray(one[k]),
                                      err_msg=k)


@pytest.mark.parametrize("n_feat,depth", [(16, 48), (7, 48), (6, 4)])
def test_pack_work_items_matches_jax(n_feat, depth):
    rs = np.random.RandomState(n_feat)
    comp = {"u": rs.randint(0, min(n_feat, depth) + 1, size=500
                            ).astype(np.int32),
            "valid": rs.rand(500) < 0.8}
    want = jshap._pack_work_items(comp, n_features=n_feat, depth=depth)
    got = tshap.pack_work_items(comp["u"], comp["valid"], n_features=n_feat,
                                depth=depth)
    assert [c for c, _ in got] == [c for c, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert max(c for c, _ in got) == min(n_feat, depth)


def test_trim_nodes_keeps_the_trees():
    _, tf = _forests("rf", 16, seed=2)
    m = int(tf.n_nodes.max())
    cut = ttrees.trim_nodes(tf, m)
    assert cut.feature.shape[1] == m and cut.value.shape[1:] == (m, 2)
    x = torch.from_numpy(_data(seed=3)[0])
    assert torch.equal(ttrees.predict_proba(cut, x),
                       ttrees.predict_proba(tf, x))


@pytest.mark.parametrize("model", ["rf", "et"])
@pytest.mark.parametrize("f", [16, 6])
def test_forest_shap_matches_jax(model, f):
    jf, tf = _forests(model, f, seed=f)
    xq = np.random.RandomState(9).randn(45, f).astype(np.float32)
    want = np.asarray(jshap.forest_shap_class0(jf, jnp.asarray(xq),
                                               impl="xla"))
    got = tshap.forest_shap_class0(tf, torch.from_numpy(xq))
    assert got.dtype == torch.float32 and got.shape == (45, f)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(float(tshap.expected_p0(tf)),
                               float(jshap.expected_p0(jf)), atol=1e-6)


@pytest.mark.parametrize("model", ["rf", "et"])
def test_local_accuracy(model):
    _, tf = _forests(model, 16, seed=5, n_trees=6, max_depth=12)
    x = torch.from_numpy(np.random.RandomState(6).randn(60, 16)
                         .astype(np.float32))
    phi = tshap.forest_shap_class0(tf, x)
    p0 = ttrees.predict_proba(tf, x)[:, 0]
    np.testing.assert_allclose(phi.sum(1).numpy(),
                               (p0 - tshap.expected_p0(tf)).numpy(),
                               atol=1e-6)


def test_write_shap_matches_jax(tmp_path):
    tj = str(tmp_path / "tests.json")
    make_tests_json(tj, n_tests=200, n_projects=5, seed=3)
    kw = dict(max_depth=12,
              tree_overrides={"Random Forest": 8, "Extra Trees": 8})
    want = jpipe.write_shap(tj, str(tmp_path / "j.pkl"), impl="xla", **kw)
    got = tpipe.write_shap(tj, str(tmp_path / "t.pkl"), device="cpu", **kw)
    with open(tmp_path / "t.pkl", "rb") as fd:
        on_disk = pickle.load(fd)
    assert len(on_disk) == len(want) == 2
    for values, res, ref in zip(on_disk, got, want):
        assert values.dtype == np.float32 and values.shape == (200, 16)
        np.testing.assert_array_equal(values, res["values"])
        np.testing.assert_allclose(values, np.asarray(ref), atol=1e-6)
        assert res["fit_s"] > 0 and res["explain_s"] > 0
    assert os.path.getsize(tmp_path / "t.pkl") > 0


def test_shap_needs_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.write_shap("missing.json")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["shap"])
