"""The model-changing arms (``F16_HIST_BINS``, ``F16_HIST_REFINE``,
``F16_ET_DRAW``, ``F16_FEATURE_QUOTA``, ``F16_PCA_IMPL``) and the engine
seed against the JAX package on the same numpy inputs, on the CPU.

Grades: forests bitwise for every arm of both growers (bins 2, 32 and 48
with their edges, refine edge, the ET rank draw, quota sklearn); the PCA
eigh basis within ``PCA_ATOL`` of the JAX package's; ``SweepEngine(seed=)``
counts equal to the JAX engine's. The JAX package reads ``ET_DRAW`` and
``FEATURE_QUOTA`` at import and caches its jitted growers' traces, so its
side sets the module constant with ``monkeypatch`` and clears jax's
caches on the way in and out (``jax_arm``); its bins and refinement are
keywords."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu.ops import preprocess as jprep
from flake16_framework_tpu.ops import trees as jtrees
from flake16_framework_tpu.parallel.sweep import SweepEngine as JEngine
from flake16_framework_tpu.utils.synth import make_dataset
from flake16_framework_tpu_torch import config as tcfg, constants, rng
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch.analysis import rules_grid
from flake16_framework_tpu_torch.kernels import hist as thist
from flake16_framework_tpu_torch.obs import perfdb
from flake16_framework_tpu_torch.ops import preprocess as tprep
from flake16_framework_tpu_torch.ops import trees as ttrees
from flake16_framework_tpu_torch.parallel import planner, sweep
from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

FIELDS = ("feature", "threshold", "left", "right", "value", "n_nodes")
ARMS = ("F16_HIST_BINS", "F16_HIST_REFINE", "F16_ET_DRAW",
        "F16_FEATURE_QUOTA", "F16_PCA_IMPL")
MODELS = {"rf": dict(bootstrap=True, random_splits=False),
          "et": dict(bootstrap=False, random_splits=True),
          "dt": dict(n_trees=1, bootstrap=False, random_splits=False,
                     sqrt_features=False)}
# The PCA eigh basis against the JAX package's: both take the
# eigenvectors of the same f32 Gram matrix, but the two LAPACK calls and
# the Gram products round differently (at most 6e-6 apart on the
# synthetic features; the basis is within 1).
PCA_ATOL = 1e-4
# PCA configs' confusion totals under eigh against svd, and against the
# JAX engine's eigh: split thresholds that land inside the ~1e-6 basis
# difference may move a few samples (the JAX package's own bound,
# tests/test_sweep.py::test_pca_config_eigh_impl_inside_cv_program).
PCA_TOTALS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops: the suite runs several
    workers on one machine, and PyTorch's default of a thread a core in
    each of them spends most of the CPU waiting. The tests' results do
    not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """No arm set, 64-bit mode off."""
    for name in ARMS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("F16_PERFDB", "0")
    with jax.enable_x64(False):
        yield


@pytest.fixture
def jax_arm(monkeypatch):
    """Sets a module constant of the JAX package's ``ops/trees.py`` (it
    reads ``ET_DRAW`` and ``FEATURE_QUOTA`` at import), with its jitted
    growers' traces dropped on the way in and out."""
    def set_arm(name, value):
        monkeypatch.setattr(jtrees, name, value)
        jax.clear_caches()

    yield set_arm
    monkeypatch.undo()
    jax.clear_caches()


def _data(n=200, f=16, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, f).astype(np.float32)
    x[:, 5] = np.round(x[:, 5])                  # ties and constant nodes
    x[:, 7] = 1.0                                # a constant feature
    x[:, 9] = np.round(x[:, 9] * 0.3)
    y = (x[:, 0] - x[:, 3] + 0.5 * rs.randn(n)) > 1.0
    w = (rs.rand(n) > 0.15).astype(np.float32)   # a fold's train mask
    return x, y, w


def _assert_forest_equal(got, want):
    for fld in FIELDS:
        a = getattr(got, fld).numpy()
        b = np.asarray(getattr(want, fld))
        assert a.dtype == b.dtype and a.shape == b.shape, fld
        assert a.tobytes() == b.tobytes(), fld


def _same(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def _fit_port(fit_t, seed=1, **kw):
    x, y, w = _data(seed=seed)
    return fit_t(torch.from_numpy(x), torch.from_numpy(y),
                 torch.from_numpy(w), rng.prng_key(seed), **kw)


def _fit_both(fit_t, fit_j, seed=1, port_kw=None, jax_kw=None, **kw):
    x, y, w = _data(seed=seed)
    want = fit_j(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                 jax.random.PRNGKey(seed), **kw, **(jax_kw or {}))
    got = fit_t(torch.from_numpy(x), torch.from_numpy(y),
                torch.from_numpy(w), rng.prng_key(seed), **kw,
                **(port_kw or {}))
    return got, want


HIST_CASES = {
    # name: (model, port keywords, JAX keywords, JAX module constants)
    "rf-bins2": ("rf", dict(n_bins=2), dict(n_bins=2), {}),
    "rf-bins32": ("rf", dict(n_bins=32), dict(n_bins=32), {}),
    "rf-bins48": ("rf", dict(n_bins=48), dict(n_bins=48), {}),
    "et-bins2": ("et", dict(n_bins=2), dict(n_bins=2), {}),
    "et-bins32": ("et", dict(n_bins=32), dict(n_bins=32), {}),
    "et-bins48": ("et", dict(n_bins=48), dict(n_bins=48), {}),
    "rf-refine-edge": ("rf", dict(refine="edge"), dict(refine="edge"), {}),
    "et-rank": ("et", dict(et_draw="rank"), {}, dict(ET_DRAW="rank")),
    "et-rank-bins32": ("et", dict(et_draw="rank", n_bins=32),
                       dict(n_bins=32), dict(ET_DRAW="rank")),
    "rf-quota-sklearn": ("rf", dict(feature_quota="sklearn"), {},
                         dict(FEATURE_QUOTA="sklearn")),
    "et-quota-sklearn": ("et", dict(feature_quota="sklearn"), {},
                         dict(FEATURE_QUOTA="sklearn")),
}


@pytest.mark.parametrize("case", list(HIST_CASES))
def test_hist_arm_bitwise_vs_jax(case, jax_arm):
    model, port_kw, jax_kw, consts = HIST_CASES[case]
    for name, val in consts.items():
        jax_arm(name, val)
    kw = dict(n_trees=3, sqrt_features=True, max_depth=8, **MODELS[model])
    got, want = _fit_both(ttrees.fit_forest_hist, jtrees.fit_forest_hist,
                          port_kw=port_kw, jax_kw=jax_kw, **kw)
    _assert_forest_equal(got, want)
    assert int(got.n_nodes.min()) > 3
    # the arm is a different model: today's default grows another forest
    assert not _same(got, _fit_port(ttrees.fit_forest_hist, **kw))


@pytest.mark.parametrize("model", ["dt", "rf", "et"])
def test_exact_quota_sklearn_bitwise_vs_jax(model, jax_arm):
    jax_arm("FEATURE_QUOTA", "sklearn")
    kw = dict(max_depth=8, **MODELS[model])
    if model != "dt":
        kw.update(n_trees=2, sqrt_features=True)
    got, want = _fit_both(ttrees.fit_forest, jtrees.fit_forest,
                          port_kw=dict(feature_quota="sklearn"), **kw)
    _assert_forest_equal(got, want)
    # all features are a Decision Tree's quota: the arm cannot move it
    assert _same(got, _fit_port(ttrees.fit_forest, **kw)) == (model == "dt")


@pytest.mark.parametrize("n_bins", [2, 32, 48, 128, 256])
def test_edges_and_bins_bitwise_vs_jax(n_bins, monkeypatch):
    x = _data(n=400, seed=3)[0]
    want = np.asarray(jtrees.quantile_edges(jnp.asarray(x), n_bins))
    got = ttrees.quantile_edges(torch.from_numpy(x), n_bins)
    assert got.numpy().tobytes() == want.tobytes()
    assert got.shape == (16, n_bins - 1)
    # the environment names the bins at the call when the caller does not
    monkeypatch.setenv("F16_HIST_BINS", str(n_bins))
    assert torch.equal(ttrees.quantile_edges(torch.from_numpy(x)), got)
    _, jbins = jtrees._bin_onehot(jnp.asarray(x), jnp.asarray(want))
    tbins = ttrees.bin_indices(torch.from_numpy(x), got)
    assert np.array_equal(tbins.numpy(), np.asarray(jbins))


def test_fold_batch_under_the_arms_equals_one_fold_fits():
    # fit_folds_hist threads the arms through the group axis
    x, y, w = _data(seed=4)
    arms = dict(n_bins=32, et_draw="rank", feature_quota="sklearn")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    wt = torch.stack([torch.from_numpy(w), torch.ones(len(w))])
    keys = rng.split(rng.prng_key(5), 2)
    edges = ttrees.quantile_edges(xt, 32)
    kw = dict(n_trees=2, sqrt_features=True, max_depth=6, **MODELS["et"])
    both = ttrees.fit_folds_hist(xt.expand(2, -1, -1), yt.expand(2, -1), wt,
                                 keys, edges=edges, **kw, **arms)
    for g in range(2):
        one = ttrees.fit_forest_hist(xt, yt, wt[g], keys[g], edges=edges,
                                     **kw, **arms)
        for fld in FIELDS:
            assert torch.equal(getattr(both, fld)[g], getattr(one, fld)), fld
    with pytest.raises(ValueError, match="the edges hold 32 bins"):
        ttrees.fit_folds_hist(xt[None], yt[None], wt[:1], keys[:1],
                              edges=edges, n_bins=48, **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_pca_eigh_within_tolerance_of_jax(seed, monkeypatch):
    x = _engine_args(n=300, seed=seed)[0].astype(np.float32)
    jmu, jw = jprep.fit_preprocess(jnp.asarray(x), tcfg.PREP_PCA,
                                   pca_impl="eigh")
    mu, w = tprep.fit_preprocess(torch.from_numpy(x), tcfg.PREP_PCA,
                                 pca_impl="eigh")
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=0,
                               atol=PCA_ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                               atol=PCA_ATOL)
    # the environment picks the arm at the call; svd stays the default
    monkeypatch.setenv("F16_PCA_IMPL", "eigh")
    assert torch.equal(tprep.fit_preprocess(torch.from_numpy(x),
                                            tcfg.PREP_PCA)[1], w)
    monkeypatch.delenv("F16_PCA_IMPL")
    _, w_svd = tprep.fit_preprocess(torch.from_numpy(x), tcfg.PREP_PCA)
    assert tprep.pca_impl_of() == "svd"
    np.testing.assert_allclose(w_svd.numpy(), w.numpy(), rtol=0,
                               atol=PCA_ATOL)


@pytest.mark.parametrize("name,value,resolver,match", [
    ("F16_ET_DRAW", "rnak", ttrees.et_draw, "F16_ET_DRAW must be value|rank"),
    ("F16_HIST_REFINE", "midpoint", ttrees.hist_refine,
     "F16_HIST_REFINE must be exact|edge"),
    ("F16_FEATURE_QUOTA", "all", ttrees.feature_quota,
     "F16_FEATURE_QUOTA must be sklearn|informative"),
    ("F16_PCA_IMPL", "qr", tprep.pca_impl_of,
     "pca_impl/F16_PCA_IMPL must be svd|eigh"),
    ("F16_HIST_BINS", "1", ttrees.hist_bins, "from 2 to 256"),
    ("F16_HIST_BINS", "257", ttrees.hist_bins, "K1 takes at most 256"),
    ("F16_HIST_BINS", "6x", ttrees.hist_bins, "whole number"),
])
def test_an_arm_outside_its_domain_raises(name, value, resolver, match,
                                          monkeypatch):
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=match):
        resolver()
    # the JAX package's words for the four it validates
    if name not in ("F16_HIST_BINS",):
        assert rules_grid.preflight_knob_values({name: value})
    x = torch.zeros((8, 3))
    with pytest.raises(ValueError, match=match):
        if name == "F16_PCA_IMPL":
            tprep.fit_preprocess(x, tcfg.PREP_NONE)
        elif name == "F16_FEATURE_QUOTA":
            ttrees.fit_forest(x, torch.zeros(8), torch.ones(8),
                              rng.prng_key(0), **MODELS["dt"])
        else:
            ttrees.fit_forest_hist(x, torch.zeros(8), torch.ones(8),
                                   rng.prng_key(0), n_trees=2,
                                   sqrt_features=True, **MODELS["et"])


def test_defaults_are_the_jax_packages_and_explicit_wins(monkeypatch):
    assert (ttrees.hist_bins(), ttrees.hist_refine(), ttrees.et_draw(),
            ttrees.feature_quota(), tprep.pca_impl_of()) == (
        jtrees.HIST_BINS, jtrees.HIST_REFINE, jtrees.ET_DRAW,
        jtrees.FEATURE_QUOTA, "svd")
    for name, val in zip(ARMS, ("48", "edge", "rank", "sklearn", "eigh")):
        monkeypatch.setenv(name, val)
    assert (ttrees.hist_bins(), ttrees.hist_refine(), ttrees.et_draw(),
            ttrees.feature_quota(), tprep.pca_impl_of()) == (
        48, "edge", "rank", "sklearn", "eigh")
    assert (ttrees.hist_bins(32), ttrees.hist_refine("exact"),
            ttrees.et_draw("value"), ttrees.feature_quota("informative"),
            tprep.pca_impl_of("svd")) == (
        32, "exact", "value", "informative", "svd")
    assert ttrees.hist_bins(2) == 2 and ttrees.hist_bins(256) == 256


@pytest.mark.parametrize("n_bins,cuda_width", [
    (32, 128), (48, 128), (64, 128), (128, 113), (256, 56)])
def test_default_width_is_clamped_to_k1s_window(n_bins, cuda_width,
                                                monkeypatch):
    assert thist.max_window(n_bins) >= cuda_width
    assert ttrees.default_node_batch("cuda", n_bins=n_bins) == cuda_width
    assert ttrees.default_node_batch("cpu", n_bins=n_bins) == 8
    monkeypatch.setenv("F16_HIST_BINS", str(n_bins))
    assert ttrees.default_node_batch("cuda") == cuda_width
    # an operator's pin over the window still raises
    monkeypatch.setenv("F16_HIST_NODE_BATCH", str(thist.max_window(n_bins)
                                                  + 1))
    with pytest.raises(ValueError, match="window width"):
        ttrees.default_node_batch("cuda")


def test_stage_flops_read_the_bins():
    kw = dict(n=400, n_feat=16, n_trees=10, n_nodes=800, max_nodes=1600,
              node_batch=8)
    for b in (32, 48, 64):
        assert ttrees.fit_stage_flops(n_bins=b, **kw) == \
            jtrees.fit_stage_flops(n_bins=b, **kw)
    assert ttrees.fit_stage_flops(n_bins=32, **kw)["hist_build"] * 2 == \
        ttrees.fit_stage_flops(n_bins=64, **kw)["hist_build"]


def _engine_args(n=160, seed=2):
    feats, labels, pids = make_dataset(n_tests=n, n_projects=4, seed=seed)
    names = [f"project{p:02d}" for p in range(4)]
    return feats, labels, np.array([names[p] for p in pids]), names, pids


# The Decision Tree's seeds are held against the JAX engine by
# tests/test_torch_parity.py (the probe configs over two seeds).
SEED_CONFIGS = [("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest")]


def test_engine_seed_equals_jax_and_zero_is_todays():
    args = _engine_args()
    over = {"Random Forest": 3}
    eng = SweepEngine(*args, tree_overrides=over, max_depth=8,
                      device="cpu", seed=3)
    jeng = JEngine(*args, tree_overrides=over, max_depth=8, seed=3)
    zero = SweepEngine(*args, tree_overrides=over, max_depth=8,
                       device="cpu")
    assert zero.seed == 0 and eng.seed == 3
    for keys in SEED_CONFIGS:
        got, want = eng.run_config(keys), jeng.run_config(keys)
        assert got[2] == want[2] and got[3] == want[3], keys
        # the seed reaches the fold keys; seed 0 is the engine default
        assert not torch.equal(eng._fold_keys(keys), zero._fold_keys(keys))
        zero.seed = 3
        assert zero.run_config(keys)[2:] == got[2:]
        zero.seed = 0


def test_pca_eigh_engine_totals_near_svd_and_jax(monkeypatch):
    args = _engine_args(n=160, seed=4)
    keys = ("NOD", "Flake16", "PCA", "Tomek Links", "Random Forest")
    over = {"Random Forest": 2}

    def totals(engine):
        return np.array(engine.run_config(keys)[3][:3], float)

    svd = totals(SweepEngine(*args, tree_overrides=over, max_depth=6,
                             device="cpu"))
    monkeypatch.setenv("F16_PCA_IMPL", "eigh")
    eigh = totals(SweepEngine(*args, tree_overrides=over, max_depth=6,
                              device="cpu"))
    jeigh = totals(JEngine(*args, tree_overrides=over, max_depth=6))
    assert np.abs(eigh - svd).sum() <= PCA_TOTALS, (eigh, svd)
    assert np.abs(eigh - jeigh).sum() <= PCA_TOTALS, (eigh, jeigh)


def test_seed_reaches_plans_batches_and_the_journal(tmp_path):
    args = _engine_args(n=120)
    over = {"Random Forest": 2}
    rf = [("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
          ("NOD", "Flake16", "None", "SMOTE", "Random Forest")]
    per = SweepEngine(*args, tree_overrides=over, max_depth=6,
                      device="cpu", seed=5)
    want = {k: per.run_config(k)[2:] for k in rf}
    for mode in (dict(planner_mode=True), dict(devices=["cpu"] * 2)):
        eng = SweepEngine(*args, tree_overrides=over, max_depth=6, seed=5,
                          **({} if "devices" in mode else {"device": "cpu"}),
                          **mode)
        got = eng.run_grid(rf)
        assert {k: v[2:] for k, v in got.items()} == want, mode
    fp = tpipe._journal_fingerprint(per, cv="stratified", max_depth=6,
                                    tree_overrides=over)
    assert fp["seed"] == 5
    per.seed = 0
    assert tpipe._journal_fingerprint(per, cv="stratified", max_depth=6,
                                      tree_overrides=over)["seed"] == 0


def test_bins_flow_into_the_sweep_envelope_and_window_bound(monkeypatch):
    args = _engine_args()
    keys = ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest")
    eng = SweepEngine(*args, tree_overrides={"Random Forest": 2},
                      max_depth=6, device="cpu")
    assert eng._prepare(keys)["edges"].shape[-1] == 63
    (plan,) = planner.plan_grid([keys], devices=1, n=4000, n_folds=10,
                                tree_overrides={"Random Forest": 100})
    kw = dict(n_projects=26, max_depth=48, grower=None, device_type="cuda")
    at64 = sweep.plan_envelope(plan, **kw)["peak_bytes"]
    monkeypatch.setenv("F16_HIST_BINS", "32")
    assert eng._prepare(keys)["edges"].shape[-1] == 31
    at32 = sweep.plan_envelope(plan, **kw)["peak_bytes"]
    assert at32 < at64
    # the tuned width's bound follows the bins (113 nodes at 128)
    monkeypatch.setenv("F16_HIST_BINS", "128")
    assert perfdb._k1_window_max() == thist.max_window(128) == 113
    monkeypatch.delenv("F16_HIST_BINS")
    assert perfdb._k1_window_max() == thist.max_window(constants.HIST_BINS)


def test_write_scores_under_an_arm_matches_jax_engine(tmp_path, monkeypatch,
                                                     jax_arm):
    # the arms read at the call reach every fold through the sweep
    from flake16_framework_tpu.utils.synth import make_tests_json

    jax_arm("ET_DRAW", "rank")
    monkeypatch.setenv("F16_ET_DRAW", "rank")
    tj = str(tmp_path / "tests.json")
    make_tests_json(tj, n_tests=160, n_projects=4, seed=3)
    keys = ("NOD", "Flake16", "None", "Tomek Links", "Extra Trees")
    from flake16_framework_tpu import pipeline as jpipe

    kw = dict(max_depth=6, configs=[keys], progress_out=io.StringIO(),
              tree_overrides={"Extra Trees": 2})
    want = jpipe.write_scores(tj, str(tmp_path / "j.pkl"), journal=False,
                              **kw)
    got = tpipe.write_scores(tj, str(tmp_path / "t.pkl"), device="cpu",
                             **kw)
    assert got[keys][2:] == want[keys][2:]


def test_lint_registers_the_arms_with_the_jax_kinds():
    from flake16_framework_tpu.analysis import rules_grid as jgrid

    for name in ARMS:
        kind, detail = rules_grid.KNOBS[name]
        assert (kind, detail if name != "F16_HIST_BINS" else detail[0]) \
            == jgrid.KNOBS[name]
    assert rules_grid.KNOBS["F16_HIST_BINS"] == ("int", (2, 256))
    ok = rules_grid.preflight_knob_values
    assert not ok({"F16_HIST_BINS": "256", "F16_PCA_IMPL": ""})
    (bad,) = ok({"F16_HIST_BINS": "300"})
    assert "int in [2, 256]" in bad.message
