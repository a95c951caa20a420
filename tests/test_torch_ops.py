"""The port's preprocessing, kNN and resamplers against the JAX package on
the same numpy inputs. Grades, per test: scaler rtol=1e-6; PCA transform
atol=1e-4 after the sign rule (two LAPACKs); kNN indices equal on tie-free
inputs and distances rtol=1e-5; Tomek and ENN keep-masks equal; resampled
rows, labels and validity bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu.ops import knn as jknn, preprocess as jprep
from flake16_framework_tpu.ops import resample as jres
from flake16_framework_tpu.utils.synth import make_dataset
from flake16_framework_tpu_torch import rng
from flake16_framework_tpu_torch.ops import knn as tknn, preprocess as tprep
from flake16_framework_tpu_torch.ops import resample as tres


@pytest.fixture(autouse=True)
def _jax_x64_off():
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    with jax.enable_x64(False):
        yield


def _feats(n=160, seed=0):
    x, labels, _ = make_dataset(n_tests=n, n_projects=4, seed=seed)
    return x.astype(np.float32), labels == 2


def _blobs(n=120, f=5, seed=0, frac=0.25):
    rs = np.random.RandomState(seed)
    y = rs.rand(n) < frac
    x = (rs.randn(n, f) + 1.5 * y[:, None]).astype(np.float32)
    return x, y


@pytest.mark.parametrize("seed", [0, 1])
def test_scaler_rtol_1e6(seed):
    x, _ = _feats(seed=seed)
    mu_j, w_j = jprep.fit_preprocess(jnp.asarray(x), 1)
    mu_t, w_t = tprep.fit_preprocess(torch.from_numpy(x), 1)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-6)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6)
    np.testing.assert_allclose(
        tprep.transform(torch.from_numpy(x), mu_t, w_t).numpy(),
        np.asarray(jprep.transform(jnp.asarray(x), mu_j, w_j)),
        rtol=1e-6, atol=1e-6)


def _correlated(n=160, f=16, seed=0):
    """Correlated features with a decaying spectrum, so each principal
    direction is well separated from the next."""
    rs = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rs.randn(f, f))
    scales = 10.0 ** rs.uniform(-1, 2, f)
    x = (rs.randn(n, f) * 0.7 ** np.arange(f)) @ q.T * scales + 5.0
    return x.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pca_transform_atol_1e4(seed):
    x = _correlated(seed=seed)
    x[:, 7] = 3.0                           # a zero-variance column
    mu_j, w_j = jprep.fit_preprocess(jnp.asarray(x), 2, pca_impl="svd")
    mu_t, w_t = tprep.fit_preprocess(torch.from_numpy(x), 2)
    want = np.asarray(jprep.transform(jnp.asarray(x), mu_j, w_j))
    got = tprep.transform(torch.from_numpy(x), mu_t, w_t).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_no_preprocessing_is_identity():
    x, _ = _feats()
    mu, w = tprep.fit_preprocess(torch.from_numpy(x), 0)
    assert torch.equal(tprep.transform(torch.from_numpy(x), mu, w),
                       torch.from_numpy(x))
    with pytest.raises(ValueError):
        tprep.fit_preprocess(torch.from_numpy(x), 3)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_knn_tie_free(seed, k):
    x, y = _blobs(seed=seed)
    valid = ~y | (np.arange(len(y)) % 3 == 0)
    idx_j, ok_j = jknn.masked_knn(jnp.asarray(x), jnp.asarray(valid), k)
    idx_t, ok_t = tknn.masked_knn(torch.from_numpy(x),
                                  torch.from_numpy(valid), k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(
        tknn.nearest_one(torch.from_numpy(x), torch.from_numpy(valid)).numpy(),
        np.asarray(jknn.nearest_one(jnp.asarray(x), jnp.asarray(valid))))
    np.testing.assert_allclose(
        tknn.pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(x)).numpy(),
        np.asarray(jknn.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def test_knn_ties_go_to_lowest_index():
    x = np.zeros((6, 2), np.float32)
    x[3:] = 1.0
    idx, ok = tknn.masked_knn(torch.from_numpy(x), torch.ones(6, dtype=bool), 4)
    np.testing.assert_array_equal(idx[0].numpy(), [1, 2, 3, 4])
    assert tknn.nearest_one(torch.from_numpy(x), torch.ones(6, dtype=bool))[5] == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("strategy_all", [False, True])
def test_tomek_and_enn_keep_equal(seed, strategy_all):
    x, y = _blobs(seed=seed)
    w = (np.random.RandomState(seed + 7).rand(len(y)) > 0.1).astype(np.float32)
    args_j = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    args_t = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w))
    for jf, tf in ((jres.tomek_keep, tres.tomek_keep),
                   (jres.enn_keep, tres.enn_keep)):
        np.testing.assert_array_equal(
            tf(*args_t, strategy_all=strategy_all).numpy(),
            np.asarray(jf(*args_j, strategy_all=strategy_all)))


@pytest.mark.parametrize("code", range(6))
def test_resample_rows(code):
    x, y = _blobs(seed=code, f=6)
    n = len(y)
    w = (np.random.RandomState(code).rand(n) > 0.1).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), code)
    xj, yj, wj = jres.resample(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                               jnp.int32(code), key, 2 * n)
    xt, yt, wt = tres.resample(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w), code,
        torch.from_numpy(np.asarray(key, np.int64)), 2 * n)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    if code == 2:
        assert wt[n:].sum() > 0       # SMOTE synthesized rows


def test_smote_without_minority_is_noop():
    x, _ = _blobs()
    y = np.zeros(len(x), bool)
    xs, ys, ws = tres.smote(torch.from_numpy(x), torch.from_numpy(y),
                            torch.ones(len(x)), rng.prng_key(0), 2 * len(x))
    assert ws[len(x):].sum() == 0 and xs.shape == (2 * len(x), x.shape[1])
    with pytest.raises(ValueError):
        tres.resample(torch.from_numpy(x), torch.from_numpy(y),
                      torch.ones(len(x)), 6, rng.prng_key(0), 2 * len(x))
