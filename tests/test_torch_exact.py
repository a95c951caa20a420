"""The port's exact sort-based grower, LOPO folds and the Decision Tree
and LOPO sweeps against the JAX package's on the same inputs and keys.
Grades: bitwise for every Forest field, for the grower's helpers, for
predict and for the fold masks; per-project counts equal for configs
without PCA and total F1 within +/-0.01 with PCA."""

import io
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu import pipeline as jpipe
from flake16_framework_tpu.ops import trees as jtrees
from flake16_framework_tpu.parallel import folds as jfolds
from flake16_framework_tpu.utils.synth import make_tests_json
from flake16_framework_tpu_torch import config as tcfg, rng
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch.ops import trees as ttrees
from flake16_framework_tpu_torch.parallel import folds as tfolds
from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
from flake16_framework_tpu_torch.weights import forest_from_numpy

FIELDS = ("feature", "threshold", "left", "right", "value", "n_nodes")


@pytest.fixture(autouse=True)
def _jax_x64_off():
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    with jax.enable_x64(False):
        yield


def _data(n=300, f=16, seed=0, edge=False):
    """A fold's train set. ``edge``: a constant feature, a feature of three
    tied values, and a region of one class (pure nodes)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, f).astype(np.float32)
    x[:, 5] = np.round(x[:, 5])                  # ties
    y = (x[:, 0] - x[:, 3] + 0.5 * rs.randn(n)) > 0.5
    if edge:
        x[:, 2] = 1.5                            # constant
        x[:, 7] = np.clip(np.round(x[:, 7]), -1, 1)
        y = np.where(x[:, 1] > 0.8, True, y)     # pure beyond x1 = 0.8
    w = (rs.rand(n) > 0.15).astype(np.float32)   # rows of weight 0
    return x, y, w


def _assert_forest_equal(got, want):
    for fld in FIELDS:
        a = getattr(got, fld).numpy()
        b = np.asarray(getattr(want, fld))
        assert a.dtype == b.dtype and a.shape == b.shape, fld
        assert a.tobytes() == b.tobytes(), fld
    assert got.max_depth == int(want.max_depth)


DT = dict(n_trees=1, bootstrap=False, random_splits=False,
          sqrt_features=False)
RF = dict(n_trees=3, bootstrap=True, random_splits=False, sqrt_features=True)
ET = dict(n_trees=3, bootstrap=False, random_splits=True, sqrt_features=True)

FOREST_CASES = [
    pytest.param(DT, dict(seed=0), {}, id="dt-seed0"),
    pytest.param(DT, dict(seed=1, n=500), {}, id="dt-seed1"),
    pytest.param(RF, dict(seed=2), {}, id="rf-exact-tier"),
    pytest.param(ET, dict(seed=3), {}, id="et-exact-tier"),
    pytest.param(DT, dict(seed=4, edge=True), {}, id="dt-edge"),
    pytest.param(ET, dict(seed=5, edge=True), {}, id="et-edge"),
    pytest.param(DT, dict(seed=6), dict(max_nodes=15), id="dt-capacity"),
    pytest.param(RF, dict(seed=7), dict(max_depth=1), id="rf-depth1"),
    pytest.param(DT, dict(seed=8), dict(max_depth=1), id="dt-depth1"),
]


@pytest.mark.parametrize("model,data,limits", FOREST_CASES)
def test_forest_bitwise(model, data, limits):
    x, y, w = _data(**data)
    kw = {"max_depth": 48, **model, **limits}
    seed = data["seed"]
    want = jtrees.fit_forest(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                             jax.random.PRNGKey(seed), **kw)
    got = ttrees.fit_forest(torch.from_numpy(x), torch.from_numpy(y),
                            torch.from_numpy(w), rng.prng_key(seed), **kw)
    _assert_forest_equal(got, want)
    n_nodes = got.n_nodes.numpy()
    if "max_nodes" in limits:                    # growth stopped by capacity
        assert (n_nodes == limits["max_nodes"]).all()
    elif limits.get("max_depth") == 1:
        assert (n_nodes == 3).all()
    else:
        assert n_nodes.min() > 15


def _runs(seed, f=3, n=200):
    """Sorted node ids [f, n] (n = parked) with runs of every length, and
    scores with runs of all -inf and tied maxima."""
    rs = np.random.RandomState(seed)
    ids = np.sort(rs.choice(np.r_[np.arange(12), [n] * 4], size=(f, n)), 1)
    score = np.round(rs.randn(f, n) * 2).astype(np.float32)
    score[rs.rand(f, n) < 0.3] = -np.inf
    score[ids == 3] = -np.inf                    # a run of all -inf
    vals = rs.randint(0, 3, size=(f, n)).astype(np.float32)
    return ids.astype(np.int32), score, vals


@pytest.mark.parametrize("seed", [0, 1])
def test_helpers_bitwise(seed):
    ids, score, vals = _runs(seed)
    n = ids.shape[1]
    js, je = jtrees._run_boundaries(jnp.asarray(ids))
    ts, te = ttrees._run_boundaries(torch.from_numpy(ids).long())
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    for got, want in zip(ttrees._prefix_stats(torch.from_numpy(vals), ts, te),
                         jtrees._prefix_stats(jnp.asarray(vals), js, je)):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()

    # the run-start best: the run's max score and its lowest position
    jb, jp = jtrees._segmented_suffix_best(jnp.asarray(ids),
                                           jnp.asarray(score), n)
    tb, tp = ttrees._run_best(torch.from_numpy(ids).long(),
                              torch.from_numpy(score))
    start = np.asarray(js)
    for f in range(ids.shape[0]):
        pos = np.nonzero(start[f])[0]
        rid = ids[f, pos]
        np.testing.assert_array_equal(tb.numpy()[f, rid], np.asarray(jb)[f, pos])
        np.testing.assert_array_equal(tp.numpy()[f, rid], np.asarray(jp)[f, pos])
    assert np.isneginf(tb.numpy()[:, 3]).all()   # the all -inf run...
    assert (tp.numpy()[:, 3] == np.asarray(jp)[np.arange(3), np.argmax(
        ids == 3, 1)]).all()                     # ...gives its start

    sample_rel = ids[0][np.random.RandomState(seed).permutation(n)]
    for got, want in zip(
            ttrees._node_lookup(torch.from_numpy(sample_rel).long(), n),
            jtrees._node_lookup(jnp.asarray(sample_rel), n)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fma_matches_xla_contraction():
    """XLA contracts the JAX package's ``c + a * b`` (the Extra Trees
    threshold draws of both growers) into one fused multiply-add on the
    CPU; ``_fma`` gives the same bits, where two roundings do not."""
    rs = np.random.RandomState(0)
    a = rs.rand(200000).astype(np.float32)
    b = (rs.randn(200000) * 3).astype(np.float32)
    c = (rs.randn(200000) * 2).astype(np.float32)
    c[:1000] = -a[:1000] * b[:1000]              # cancellation
    want = np.asarray(jax.jit(lambda a, b, c: c + a * b)(a, b, c))
    got = ttrees._fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    assert got.tobytes() == want.tobytes()
    twice = c + a * b
    assert (twice != want).sum() > 1000


def test_predict_on_a_jax_dt_forest():
    x, y, w = _data(seed=9)
    jf = jtrees.fit_forest(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                           jax.random.PRNGKey(2), max_depth=48, **DT)
    tf = forest_from_numpy(jtrees.Forest(*[np.asarray(a) for a in jf]),
                           device="cpu")
    xq = np.concatenate([
        x[:40], np.random.RandomState(7).randn(80, 16).astype(np.float32)])
    want = np.asarray(jtrees.predict_proba(jf, jnp.asarray(xq)))
    got = ttrees.predict_proba(tf, torch.from_numpy(xq)).numpy()
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(
        ttrees.predict(tf, torch.from_numpy(xq)).numpy(),
        np.asarray(jtrees.predict(jf, jnp.asarray(xq))))


def test_tier_rule():
    assert ttrees.hist_tier_default(100)
    assert not ttrees.hist_tier_default(1)
    for spec in tcfg.MODELS.values():
        assert ttrees.hist_tier_default(spec.n_trees) == \
            jtrees.hist_tier_default(spec.n_trees)


def _assert_scores_match(got, want, configs):
    assert list(got) == list(configs)
    for k in configs:
        g, w = got[k], want[k]
        assert len(g) == 4 and g[0] > 0 and g[1] > 0
        assert list(g[2]) == list(w[2])          # projects, in order
        if k[2] != "PCA":
            assert g[2] == w[2] and g[3] == w[3], k
        else:
            gf, wf = g[3][5], w[3][5]
            assert (gf is None) == (wf is None), k
            if gf is not None:
                assert abs(gf - wf) <= 0.01, (k, gf, wf)


# All six balancings, all three preprocessings, both flaky types.
DT_CONFIGS = [
    ("NOD", "Flake16", "None", "None", "Decision Tree"),
    ("OD", "Flake16", "Scaling", "Tomek Links", "Decision Tree"),
    ("NOD", "FlakeFlagger", "PCA", "SMOTE", "Decision Tree"),
    ("OD", "FlakeFlagger", "None", "ENN", "Decision Tree"),
    ("NOD", "Flake16", "Scaling", "SMOTE ENN", "Decision Tree"),
    ("OD", "Flake16", "PCA", "SMOTE Tomek", "Decision Tree"),
]


def test_write_scores_decision_trees_match_jax(tmp_path):
    tj = str(tmp_path / "tests.json")
    make_tests_json(tj, n_tests=200, n_projects=5, seed=0)
    kw = dict(max_depth=8, configs=DT_CONFIGS, progress_out=io.StringIO())
    want = jpipe.write_scores(tj, str(tmp_path / "j.pkl"), journal=False,
                              **kw)
    got = tpipe.write_scores(tj, str(tmp_path / "t.pkl"), device="cpu",
                             **kw)
    _assert_scores_match(got, want, DT_CONFIGS)


def test_lopo_fold_masks_equal():
    pids = np.sort(np.random.RandomState(0).randint(0, 7, size=300))
    for got, want in zip(tfolds.lopo_fold_masks(pids, 7),
                         jfolds.lopo_fold_masks(pids, 7)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


LOPO_CONFIGS = [
    ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
    ("OD", "FlakeFlagger", "None", "Tomek Links", "Decision Tree"),
]


def test_write_scores_lopo_matches_jax(tmp_path, monkeypatch):
    tj = str(tmp_path / "tests.json")
    make_tests_json(tj, n_tests=200, n_projects=5, seed=1)
    kw = dict(max_depth=8, configs=LOPO_CONFIGS, progress_out=io.StringIO(),
              tree_overrides={"Random Forest": 3}, cv="lopo")
    want = jpipe.write_scores(tj, str(tmp_path / "j.pkl"), journal=False,
                              **kw)
    monkeypatch.chdir(tmp_path)
    got = tpipe.write_scores(tj, device="cpu", **kw)
    _assert_scores_match(got, want, LOPO_CONFIGS)
    assert not os.path.exists("scores.pkl")
    with open("scores-lopo.pkl", "rb") as fd:
        assert pickle.load(fd) == got


def test_lopo_engine_takes_its_folds_from_the_projects():
    feats = np.zeros((6, 16), np.float32)
    args = (feats, np.zeros(6, np.int32), {}, ["a", "b", "c"],
            np.array([0, 0, 1, 1, 2, 2]))
    engine = SweepEngine(*args, cv="lopo", device="cpu")
    assert engine.n_folds == 3
    train, test = engine._masks["OD"]
    assert test.sum(1).tolist() == [2, 2, 2]
    assert torch.equal(train, 1 - test)
    with pytest.raises(ValueError, match="unknown cv scheme"):
        SweepEngine(*args, cv="loo", device="cpu")


def test_shap_fit_follows_the_tier_rule(monkeypatch):
    """``fit_shap_model`` grows a Decision Tree on the exact grower and an
    ensemble on the histogram grower."""
    rs = np.random.RandomState(0)
    feats = rs.lognormal(size=(120, 16)).astype(np.float32)
    labels = rs.choice([0, 1, 2], size=120, p=[0.6, 0.2, 0.2])
    calls = []
    for name in ("fit_forest", "fit_forest_hist"):
        real = getattr(ttrees, name)
        monkeypatch.setattr(ttrees, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    for model in ("Decision Tree", "Random Forest"):
        keys = ("NOD", "Flake16", "Scaling", "SMOTE", model)
        _, _, _, forest = tpipe.fit_shap_model(
            keys, feats, labels, max_depth=6,
            tree_overrides={"Random Forest": 2}, device="cpu")
        assert forest.feature.shape[0] == (1 if model == "Decision Tree"
                                           else 2)
    assert calls == ["fit_forest", "fit_forest_hist"]
