"""The port's copies of the grid, loader, fold masks and synthetic data,
and its confusion counting, against the JAX package. Grade: equal."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu import config as jcfg, data as jdata
from flake16_framework_tpu.ops import metrics as jmetrics
from flake16_framework_tpu.parallel import folds as jfolds
from flake16_framework_tpu.utils import synth as jsynth
from flake16_framework_tpu_torch import config as tcfg, data as tdata
from flake16_framework_tpu_torch.ops import metrics as tmetrics
from flake16_framework_tpu_torch.parallel import folds as tfolds
from flake16_framework_tpu_torch.utils import synth as tsynth


@pytest.fixture(autouse=True)
def _jax_x64_off():
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    with jax.enable_x64(False):
        yield


def test_grid_order_and_resolution():
    jk = list(jcfg.iter_config_keys())
    tk = list(tcfg.iter_config_keys())
    assert tk == jk and len(tk) == 216
    for k in tk:
        jr, tr = jcfg.resolve_config(k), tcfg.resolve_config(k)
        assert tr[:4] == jr[:4]
        assert (tr[4].name, tr[4].n_trees, tr[4].bootstrap,
                tr[4].random_splits, tr[4].sqrt_features) == \
            (jr[4].name, jr[4].n_trees, jr[4].bootstrap,
             jr[4].random_splits, jr[4].sqrt_features)


@pytest.mark.parametrize("seed", [0, 3])
def test_synth_and_loader(tmp_path, seed):
    tj = tmp_path / "tests.json"
    tsynth.make_tests_json(str(tj), n_tests=150, n_projects=7, seed=seed)
    want = jsynth.make_tests_json(None, n_tests=150, n_projects=7, seed=seed)
    with open(tj) as fd:
        got = json.load(fd)
    assert got == want
    a = tdata.tests_to_arrays(tdata.load_tests(str(tj)))
    b = jdata.tests_to_arrays(jdata.load_tests(str(tj)))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_masks_equal(seed):
    labels = np.random.RandomState(seed).choice([0, 1, 2], 257,
                                                p=[0.8, 0.1, 0.1])
    for fl in (1, 2):
        for a, b in zip(tfolds.fold_masks(labels == fl),
                        jfolds.fold_masks(labels == fl)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_and_format_equal(seed):
    rs = np.random.RandomState(seed)
    n, p = 200, 6
    labels = rs.rand(n) < 0.3
    preds = rs.rand(10, n) < 0.4
    test_mask = (rs.rand(10, n) < 0.1).astype(np.float32)
    pids = np.sort(rs.randint(0, p, n)).astype(np.int32)
    want = np.asarray(jmetrics.confusion_by_project(
        jnp.asarray(labels), jnp.asarray(preds), jnp.asarray(test_mask),
        jnp.asarray(pids), p))
    got = tmetrics.confusion_by_project(
        torch.from_numpy(labels), torch.from_numpy(preds),
        torch.from_numpy(test_mask), torch.from_numpy(pids), p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    names = [f"p{i}" for i in range(p)]
    projects = np.asarray([names[i] for i in pids])
    assert tmetrics.format_scores(got.numpy(), names, projects) == \
        jmetrics.format_scores(want, names, projects)
    assert tmetrics.get_prf(0, 0, 0) == jmetrics.get_prf(0, 0, 0)
