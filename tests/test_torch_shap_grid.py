"""The port's whole-grid SHAP (``pipeline.shap_grid`` and the ``shap
grid|interventional|interaction`` command line) against the JAX package's
on the same data and seed. Grades: explain plans equal; a member's
preprocessed samples and forest bitwise (configs without PCA); values
within atol 1e-6, with the same keys, order, shapes and dtypes;
interaction matrices exactly symmetric; error messages equal."""

import io
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu import __main__ as jmain
from flake16_framework_tpu import config as jcfg
from flake16_framework_tpu import pipeline as jpipe
from flake16_framework_tpu.ops import preprocess as jprep
from flake16_framework_tpu.ops import resample as jres
from flake16_framework_tpu.ops import trees as jtrees
from flake16_framework_tpu.parallel import planner as jplanner
from flake16_framework_tpu.utils.synth import make_dataset
from flake16_framework_tpu_torch import __main__ as tmain
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch import rng as trng
from flake16_framework_tpu_torch.parallel import planner as tplanner


@pytest.fixture(autouse=True)
def _jax_x64_off():
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    with jax.enable_x64(False):
        yield


# Without preprocessing, so that the two packages' samples, and so their
# forests, are bitwise equal (the scaler's mean and variance may differ by
# an ulp): an RF on the Flake16 features, an ET on FlakeFlagger's seven, a
# Decision Tree (exact grower).
CONFIGS = [
    ("NOD", "Flake16", "None", "SMOTE", "Random Forest"),
    ("OD", "FlakeFlagger", "None", "Tomek Links", "Extra Trees"),
    ("NOD", "Flake16", "None", "SMOTE Tomek", "Decision Tree"),
]
SMALL = dict(max_depth=6, tree_overrides={"Random Forest": 3,
                                          "Extra Trees": 3})


def _plans(mod, configs, **kw):
    return [(p.family, p.configs, p.indices, p.shape, p.batch, p.pad)
            for p in mod.plan_explain_grid(configs, **kw)]


def test_plan_explain_grid_matches_jax():
    grid = list(jcfg.iter_config_keys())
    shuffled = grid[:]
    random.Random(0).shuffle(shuffled)
    for configs, kw in ((grid, {}), (shuffled, {}), (
            grid[::7], {"tree_overrides": {"Extra Trees": 5}})):
        kw = dict(kw, n=4000, n_folds=0, n_explain=64)
        want = _plans(jplanner, configs, **kw)
        assert _plans(tplanner, configs, **kw) == want
    full = _plans(tplanner, grid, n=4000, n_folds=0, n_explain=64)
    assert len(full) == 6 and full[0][3] == (4000, 16, 100, 0, 8000, 64)


@pytest.fixture(scope="module")
def data():
    feats, labels, _ = make_dataset(n_tests=120, n_projects=4, seed=3)
    return feats, labels


@pytest.mark.parametrize("keys", CONFIGS, ids=["rf", "et", "dt"])
def test_member_forest_matches_jax_pieces(data, keys):
    """A grid member's fit under its ``fold_in`` key: the JAX package's
    preprocess -> split -> resample -> fit chain (``make_shap_plan_fn``'s
    ``shap_one``) against ``fit_shap_model(key=...)``, bitwise."""
    feats, labels = data
    fl, cols, prep, bal, spec = jcfg.resolve_config(keys)
    spec = type(spec)(spec.name, SMALL["tree_overrides"].get(spec.name,
                                                             spec.n_trees),
                      spec.bootstrap, spec.random_splits, spec.sqrt_features)
    index = list(jcfg.iter_config_keys()).index(keys)
    n = feats.shape[0]
    fit = jtrees.fit_forest_hist if spec.n_trees > 1 else jtrees.fit_forest

    @jax.jit
    def shap_one(x, y, key):                # one compiled program, as there
        mu, wmat = jprep.fit_preprocess(x, prep)
        xp = jprep.transform(x, mu, wmat)
        kb, kf = jax.random.split(key)
        xs, ys, ws = jres.resample(xp, y, jnp.ones(n, jnp.float32), bal, kb,
                                   2 * n)
        return xp, fit(xs, ys, ws, kf, n_trees=spec.n_trees,
                       bootstrap=spec.bootstrap,
                       random_splits=spec.random_splits,
                       sqrt_features=spec.sqrt_features, max_depth=6,
                       max_nodes=4 * n)

    xp, want = shap_one(
        jnp.asarray(np.asarray(feats[:, list(cols)], np.float32)),
        jnp.asarray(labels == fl),
        jax.random.fold_in(jax.random.PRNGKey(0), index))
    key = trng.fold_in(trng.prng_key(0), index)
    got_xp, _, _, got = tpipe.fit_shap_model(keys, feats, labels,
                                             device="cpu", key=key, **SMALL)
    assert got_xp.numpy().tobytes() == np.asarray(xp).tobytes()
    for name in jtrees.Forest._fields[:-1]:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert a.shape == b.shape and a.tobytes() == b.astype(
            a.dtype).tobytes(), name
    # the default key is the staged path's PRNGKey(0)
    *_, default = tpipe.fit_shap_model(keys, feats, labels, device="cpu",
                                       **SMALL)
    *_, zero = tpipe.fit_shap_model(keys, feats, labels, device="cpu",
                                    key=trng.prng_key(0), **SMALL)
    assert torch.equal(default.feature, zero.feature)
    assert torch.equal(default.threshold, zero.threshold)


@pytest.mark.parametrize("mode", ["path", "interventional", "interaction"])
def test_shap_grid_matches_jax(data, tmp_path, mode):
    kw = dict(mode=mode, n_explain=16, n_background=8, configs=CONFIGS,
              arrays=data, **SMALL)
    want = jpipe.shap_grid(out_file=str(tmp_path / "j.pkl"), **kw)
    log = io.StringIO()
    got = tpipe.shap_grid(out_file=str(tmp_path / "t.pkl"), device="cpu",
                          progress_out=log, **kw)
    assert list(got) == list(want) == ["/".join(k) for k in (
        CONFIGS[0], CONFIGS[2], CONFIGS[1])]          # plan order
    lines = log.getvalue().splitlines()
    assert len(lines) == 3 and lines[0].startswith("[1/3] NOD, Flake16")
    for name, w in want.items():
        g = got[name]
        assert g.dtype == np.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-6, err_msg=name)
        if mode == "interaction":
            assert np.array_equal(g, g.transpose(0, 2, 1))
    assert max(np.abs(v).max() for v in got.values()) > 1e-3
    with open(tmp_path / "t.pkl", "rb") as fd:
        on_disk = pickle.load(fd)
    with open(tmp_path / "j.pkl", "rb") as fd:
        ref = pickle.load(fd)
    assert {k: on_disk[k] for k in ("mode", "n_explain", "n_background")} \
        == {k: ref[k] for k in ("mode", "n_explain", "n_background")}
    assert on_disk["n_background"] == (8 if mode == "interventional" else 0)
    for name, v in got.items():
        assert np.array_equal(on_disk["values"][name], v)


def test_shap_grid_clips_counts_and_checks_mode(data):
    feats, labels = data
    kw = dict(configs=CONFIGS[2:], arrays=(feats[:10], labels[:10]),
              device="cpu", progress_out=io.StringIO(), **SMALL)
    got = tpipe.shap_grid(mode="interventional", n_explain=64,
                          n_background=32, **kw)
    assert next(iter(got.values())).shape == (10, 16)
    for mode, bg, msg in (("bogus", 8, "mode must be path|"),
                          ("interventional", 0, "needs n_background > 0")):
        with pytest.raises(ValueError, match=msg):
            tpipe.shap_grid(mode=mode, n_background=bg, **kw)


def test_shap_grid_needs_cuda_unless_asked(data, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.shap_grid(arrays=data, configs=CONFIGS)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["shap", "interaction"])


def test_cli_shap_modes(monkeypatch):
    calls = []
    monkeypatch.setattr(tpipe, "shap_grid",
                        lambda **kw: calls.append(("grid", kw)))
    monkeypatch.setattr(tpipe, "write_shap",
                        lambda **kw: calls.append(("shap", kw)))
    tmain.main(["shap"])
    tmain.main(["shap", "grid"])
    tmain.main(["shap", "interventional", "explain=8", "background=4"])
    tmain.main(["shap", "explain=5", "interaction"])
    assert calls == [
        ("shap", {}),
        ("grid", {"out_file": "shap-grid.pkl", "mode": "path"}),
        ("grid", {"out_file": "shap-interventional.pkl",
                  "mode": "interventional", "n_explain": 8,
                  "n_background": 4}),
        ("grid", {"out_file": "shap-interaction.pkl", "mode": "interaction",
                  "n_explain": 5}),
    ]


@pytest.mark.parametrize("argv", [
    ["shap", "grid", "interaction"],
    ["shap", "explain=3"],
    ["shap", "background=3"],
    ["shap", "grid", "gird"],
])
def test_cli_shap_errors_match_jax(argv):
    with pytest.raises(ValueError) as want:
        jmain.main(argv)
    with pytest.raises(ValueError) as got:
        tmain.main(argv)
    assert str(got.value) == str(want.value)
