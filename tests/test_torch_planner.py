"""The port's plan executor (``parallel/planner.py``, ``SweepEngine``'s
``planner_mode``/``fused``/dispatch bounds, ``write_scores``' timing
meta, the command line) and the ensemble grower override, against the
port's own default path and the JAX package's planner on the same
configs. Grades: plans field by field and the plan table line by line;
``v[2:]`` of the plan and fused paths equal to the default path's;
against the JAX package, scores equal for configs without PCA and F1
within +/-0.01 with PCA (the PCA basis comes from another LAPACK); the
timing meta's config lists equal."""

import io
import json
import pickle
import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from flake16_framework_tpu import pipeline as jpipe
from flake16_framework_tpu.config import iter_config_keys
from flake16_framework_tpu.parallel import planner as jplanner
from flake16_framework_tpu.parallel.sweep import SweepEngine as JSweepEngine
from flake16_framework_tpu.utils.synth import make_dataset, make_tests_json
from flake16_framework_tpu_torch import __main__ as tmain
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch.ops import trees as ttrees
from flake16_framework_tpu_torch.parallel import planner as tplanner
from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
from flake16_framework_tpu_torch.resilience import inject

N_TESTS, N_PROJECTS = 240, 6
TINY = {"Extra Trees": 4, "Random Forest": 4}
GRID = [tuple(k) for k in iter_config_keys()]

# Three families: Decision Tree (three members, one with PCA), Extra Trees
# (two) and Random Forest (one).
CONFIGS = [
    ("NOD", "Flake16", "None", "None", "Decision Tree"),
    ("OD", "Flake16", "Scaling", "None", "Decision Tree"),
    ("NOD", "Flake16", "PCA", "Tomek Links", "Decision Tree"),
    ("NOD", "Flake16", "None", "None", "Extra Trees"),
    ("OD", "Flake16", "Scaling", "SMOTE", "Extra Trees"),
    ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs several
    workers on the machine's cores, and a fold batch's tensors pass the
    size above which torch's CPU kernels split across threads, whose
    barriers then wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_x64_off(monkeypatch):
    """The JAX package as it runs in production, with 64-bit mode off."""
    monkeypatch.setenv("F16_FAULT_BACKOFF_S", "0")
    monkeypatch.delenv(inject.ENV_VAR, raising=False)
    monkeypatch.delenv("F16_ENSEMBLE_GROWER", raising=False)
    with jax.enable_x64(False):
        yield


def _arrays():
    feats, labels, pids = make_dataset(n_tests=N_TESTS,
                                       n_projects=N_PROJECTS, seed=11)
    names = [f"project{p:02d}" for p in range(N_PROJECTS)]
    return feats, labels, np.array([names[p] for p in pids]), names, pids


def _engine(**kw):
    return SweepEngine(*_arrays(), max_depth=24, tree_overrides=TINY,
                       device="cpu", **kw)


def _same(got, want, configs):
    for k in configs:
        assert pickle.dumps(got[k][2:]) == pickle.dumps(want[k][2:]), k


def _close_to_jax(got, want, configs):
    for k in configs:
        if k[2] != "PCA":
            assert got[k][2:] == want[k][2:], k
        else:
            gf, wf = got[k][3][5], want[k][3][5]
            assert (gf is None) == (wf is None), k
            assert gf is None or abs(gf - wf) <= 0.01, (k, gf, wf)


@pytest.fixture(scope="module")
def default_scores():
    """The port's default path (folds one after another) on CONFIGS."""
    return _engine().run_grid(CONFIGS)


# -- the planner: host-side grid arithmetic ------------------------------


def _fields(plans):
    return [(p.family, p.configs, p.indices, p.shape, p.batch, p.pad,
             p.mask, p.padded_configs, p.padded_indices) for p in plans]


@pytest.mark.parametrize("subset,devices,overrides", [
    ("grid", 1, None), ("grid", 8, None), ("shuffled-0", 1, TINY),
    ("shuffled-1", 4, None), ("subset-2", 8, TINY), ("configs", 1, TINY),
])
def test_plan_grid_equals_jax(subset, devices, overrides):
    if subset == "grid":
        configs = GRID
    elif subset == "configs":
        configs = CONFIGS[::-1]
    else:
        name, seed = subset.split("-")
        rs = random.Random(int(seed))
        configs = list(GRID)
        rs.shuffle(configs)
        if name == "subset":
            configs = configs[:37]
        configs += configs[:5]          # duplicates collapse
    kw = dict(devices=devices, n=N_TESTS, n_folds=10,
              tree_overrides=overrides)
    got = tplanner.plan_grid(configs, **kw)
    want = jplanner.plan_grid(configs, **kw)
    assert _fields(got) == _fields(want)
    assert tplanner.plan_table(got) == jplanner.plan_table(want)
    assert tplanner.format_plan_table(got) == jplanner.format_plan_table(want)
    if subset == "grid":
        assert len(got) == 6 and sum(len(p.configs) for p in got) == 216


def test_plan_grid_rejects_off_grid_config():
    with pytest.raises(ValueError, match="not in the 216-config grid"):
        tplanner.plan_grid(
            [("NOD", "Flake16", "None", "None", "Gradient Boosting")],
            devices=1, n=N_TESTS, n_folds=10)


# -- the executor against the default path and the JAX planner -----------


def test_planner_sweep_matches_default_path(default_scores):
    eng = _engine(planner_mode=True)
    runs = []
    real = eng.run_plan
    eng.run_plan = lambda pl, guard, kw: runs.append(pl.configs) or real(
        pl, guard, kw)
    got = eng.run_grid(CONFIGS)
    assert sorted(got) == sorted(CONFIGS)
    assert sorted(len(r) for r in runs) == [1, 2, 3]   # a plan a family
    _same(got, default_scores, CONFIGS)
    assert all(len(v) == 4 and v[1] == 0.0 for v in got.values())
    assert eng.fused_configs == set(CONFIGS)
    assert eng.amortized_configs == set(CONFIGS[:5])


def test_fused_sweep_matches_default_path(default_scores):
    eng = _engine(fused=True)
    got = eng.run_grid(CONFIGS)
    _same(got, default_scores, CONFIGS)
    assert all(v[1] == 0.0 for v in got.values())
    assert eng.fused_configs == set(CONFIGS) and not eng.amortized_configs


@pytest.mark.parametrize("trees,folds", [(1, None), (3, 4), (None, 1),
                                         (2, 3)])
def test_dispatch_bounds_change_nothing(default_scores, trees, folds):
    configs = [CONFIGS[0], CONFIGS[4]]
    got = _engine(planner_mode=True, dispatch_trees=trees,
                  dispatch_folds=folds).run_grid(configs)
    _same(got, default_scores, configs)
    got = _engine(dispatch_trees=trees).run_grid(configs[1:])
    _same(got, default_scores, configs[1:])


@pytest.mark.parametrize("where", ["fit", "injected"])
def test_plan_salvage_quarantines_only_the_bad_member(default_scores,
                                                      monkeypatch, where):
    """Each plan member is a guarded call of its own: a member whose fit
    fails deterministically (``fit``), or that the injection plan
    addresses by its config index with a transient fault on every
    attempt (``injected``), is quarantined alone, its plan-mates run
    once each on the plan path and their scores equal the default
    path's, and no config falls back to ``run_config``."""
    eng = _engine(planner_mode=True)
    victim = CONFIGS[1]
    configs = CONFIGS[:3]
    real_fit = eng._fit_count_folds
    fits, singles = [], []

    def fit(keys):
        fits.append(keys)
        if where == "fit" and keys == victim:
            raise RuntimeError("shape mismatch (injected): victim only")
        return real_fit(keys)

    monkeypatch.setattr(eng, "_fit_count_folds", fit)
    monkeypatch.setattr(eng, "run_config",
                        lambda keys: singles.append(keys))
    if where == "injected":
        monkeypatch.setenv(inject.ENV_VAR,
                           f"{GRID.index(victim)}:*:transient")
    scores = eng.run_grid(configs)
    assert set(scores) == set(configs) - {victim}
    assert set(eng.quarantined) == {victim}
    rec = eng.quarantined[victim]
    _same(scores, default_scores, scores)
    assert singles == []
    if where == "fit":
        assert rec["fault_class"] == "deterministic"
        assert sorted(fits) == sorted(configs)
    else:                                   # never reaches the fit
        assert rec["fault_class"] == "transient-device"
        assert [a["attempt"] for a in rec["attempts"]] == [1, 2, 3]
        assert sorted(fits) == sorted(scores)
    assert eng.fused_configs == set(scores)
    assert eng.amortized_configs == set(scores)


def test_planner_overrun_quarantines_then_resume(tests_json, tmp_path,
                                                 monkeypatch):
    """``F16_FAULT_ENVELOPE_S`` is a deadline a plan member, as it is a
    config's on the default path. A plan whose three members each take
    well under the envelope, but together more, completes with nothing
    quarantined. A member that overruns it under ``write_scores
    (planner=True)`` is quarantined after one attempt, and while its
    orphaned worker lives no later member runs beside it (each is
    quarantined at once as an overrun). A ``resume`` under ``planner``
    then completes every config. Scores equal the default path's."""
    import threading
    import time

    from flake16_framework_tpu_torch.resilience import quarantine

    configs = CONFIGS[:3]                   # one plan of three members

    def run(name, **kw):
        return tpipe.write_scores(
            tests_json, str(tmp_path / name), configs=configs, max_depth=24,
            tree_overrides=TINY, device="cpu", progress_out=io.StringIO(),
            **kw)

    want = run("ref.pkl")
    real = SweepEngine._fit_count_folds
    monkeypatch.setenv("F16_FAULT_ENVELOPE_S", "1.5")
    monkeypatch.setattr(SweepEngine, "_fit_count_folds",
                        lambda self, keys: time.sleep(0.5) or real(self,
                                                                   keys))
    _same(run("slow.pkl", planner=True), want, configs)

    release = threading.Event()
    ran, workers = [], []

    def fit(self, keys):
        ran.append(keys)
        if not release.is_set():            # the orphan journals nothing
            workers.append(threading.current_thread())
            release.wait(30)
            raise RuntimeError("overran (injected)")
        return real(self, keys)

    monkeypatch.setattr(SweepEngine, "_fit_count_folds", fit)
    monkeypatch.setenv("F16_FAULT_ENVELOPE_S", "0.2")
    with pytest.raises(quarantine.QuarantinedConfigs) as ei:
        run("scores.pkl", planner=True)
    first = tplanner.plan_grid(configs, devices=1, n=N_TESTS,
                               n_folds=10)[0].configs[0]
    assert ran == [first]
    assert set(ei.value.quarantined) == set(configs)
    for rec in ei.value.quarantined.values():
        assert rec["fault_class"] == "envelope-overrun"
        assert [a["attempt"] for a in rec["attempts"]] == [1]
    release.set()
    workers[0].join(30)

    monkeypatch.delenv("F16_FAULT_ENVELOPE_S")
    ran.clear()
    got = run("scores.pkl", planner=True)
    assert sorted(ran) == sorted(configs)
    _same(got, want, configs)


@pytest.mark.parametrize("mode", [{"planner_mode": True}, {"fused": True}],
                         ids=["planner", "fused"])
def test_lopo_plan_and_fused_match_default_path(monkeypatch, mode):
    """Leave-one-project-out CV (one fold a project) on the plan and fused
    paths, with ``TREES_IN_FLIGHT`` cut so a config's folds grow in
    several batches (two folds of four trees, or two single trees, a
    batch), as LOPO's 26 folds do at full size: ``v[2:]`` equal to the
    default LOPO path's."""
    from flake16_framework_tpu_torch.parallel import sweep

    configs = [CONFIGS[0], CONFIGS[4], CONFIGS[5]]
    want = _engine(cv="lopo").run_grid(configs)
    monkeypatch.setattr(sweep, "TREES_IN_FLIGHT", {"hist": 8, "exact": 2})
    eng = _engine(cv="lopo", **mode)
    assert eng.n_folds == N_PROJECTS
    batches = []
    for name in ("fit_folds_hist", "fit_folds"):
        real = getattr(ttrees, name)

        def fit(*a, real=real, **kw):
            batches.append((kw["tree_chunk"], kw["fold_chunk"]))
            return real(*a, **kw)
        monkeypatch.setattr(ttrees, name, fit)
    got = eng.run_grid(configs)
    _same(got, want, configs)
    assert sorted(batches) == [(1, 2), (4, 2), (4, 2)]


# -- write_scores, the timing meta and the command line ------------------


@pytest.fixture(scope="module")
def tests_json(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch-planner")
    tj = str(d / "tests.json")
    make_tests_json(tj, n_tests=N_TESTS, n_projects=N_PROJECTS, seed=3)
    return tj


@pytest.mark.parametrize("mode,configs", [
    ("planner", CONFIGS), ("fused", CONFIGS[:2]),
])
def test_write_scores_and_timing_meta_match_jax(tests_json, tmp_path, mode,
                                               configs):
    """``write_scores(planner=True)`` and ``(fused=True)`` against the JAX
    package's on the same configs: the scores, and the timing meta's
    config lists."""
    kw = dict(configs=configs, max_depth=24, tree_overrides=TINY,
              progress_out=io.StringIO(), **{mode: True})
    # one device, as the port runs (the test harness gives jax eight)
    one = Mesh(np.array(jax.devices()[:1]), ("config",))
    want = jpipe.write_scores(tests_json, str(tmp_path / "j.pkl"),
                              journal=False, mesh=one, **kw)
    got = tpipe.write_scores(tests_json, str(tmp_path / "t.pkl"),
                             device="cpu", **kw)
    _close_to_jax(got, want, configs)
    metas = [json.load(open(str(tmp_path / f"{p}.pkl.meta.json")))
             for p in ("t", "j")]
    assert metas[0] == metas[1]
    assert metas[0]["fused_combined"] == sorted(list(k) for k in configs)
    # a default run merges into the meta an earlier run left
    tpipe.write_scores(tests_json, str(tmp_path / "t.pkl"), device="cpu",
                       **dict(kw, **{mode: False}, configs=[GRID[0]]))
    assert json.load(open(str(tmp_path / "t.pkl.meta.json"))) == metas[1]


def test_cli_accepts_planner_fused_dispatch(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(tpipe, "write_scores", lambda **kw: calls.append(kw))
    tmain.main(["scores", "planner"])
    tmain.main(["scores", "lopo", "fused", "dispatch=25"])
    tmain.main(["scores", "dispatch=0"])
    monkeypatch.chdir(tmp_path)
    open("scores.pkl", "wb").close()        # resume state to resume from
    tmain.main(["resume", "planner"])
    tmain.main(["scores", "planner", "profile=/tmp/x"])
    assert calls == [
        {"cv": "stratified", "planner": True},
        {"cv": "lopo", "fused": True, "dispatch_trees": 25},
        {"cv": "stratified", "dispatch_trees": None},
        {"cv": "stratified", "planner": True},
        {"cv": "stratified", "planner": True, "profile_dir": "/tmp/x"}]
    with pytest.raises(ValueError, match="Unrecognized resume option"):
        tmain.main(["resume", "planer"])


# -- the ensemble grower override ----------------------------------------


def test_ensemble_grower_override(monkeypatch, tests_json, default_scores):
    """``F16_ENSEMBLE_GROWER=exact`` puts ensembles on the exact grower in
    both packages: the same tier rule, the same journal fingerprint, the
    same scores, and the fold-batched exact ensembles equal the default
    path's. A bad value raises."""
    assert ttrees.hist_tier_default(100)
    monkeypatch.setenv("F16_ENSEMBLE_GROWER", "exact")
    assert not ttrees.hist_tier_default(100)
    assert ttrees.hist_tier_default(100, grower="hist")
    assert not ttrees.hist_tier_default(1, grower="hist")

    from flake16_framework_tpu.data import load_tests as jload
    from flake16_framework_tpu.data import tests_to_arrays as jarrays
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays

    fp_kw = dict(cv="stratified", max_depth=12, tree_overrides=TINY)
    jfp = jpipe._journal_fingerprint(
        JSweepEngine(*jarrays(jload(tests_json)), **fp_kw), **fp_kw)
    tfp = tpipe._journal_fingerprint(
        SweepEngine(*tests_to_arrays(load_tests(tests_json)), device="cpu",
                    **fp_kw), **fp_kw)
    assert tfp == jfp and tfp["grower"] == "exact"

    configs = [CONFIGS[5]]                      # RF, no PCA
    fits = []
    real = ttrees.fit_forest
    monkeypatch.setattr(ttrees, "fit_forest",
                        lambda *a, **k: fits.append(1) or real(*a, **k))
    default = _engine().run_grid(configs)
    assert len(fits) == 10                      # every fold, exact grower
    want = JSweepEngine(*_arrays(), max_depth=24,
                        tree_overrides=TINY).run_grid(configs)
    _close_to_jax(default, want, configs)
    _same(_engine(planner_mode=True).run_grid(configs), default, configs)
    assert default[configs[0]][2:] != default_scores[configs[0]][2:]

    monkeypatch.setenv("F16_ENSEMBLE_GROWER", "approx")
    with pytest.raises(ValueError, match="must be hist|exact"):
        ttrees.hist_tier_default(100)
    with pytest.raises(ValueError, match="must be hist|exact"):
        _engine()
    monkeypatch.delenv("F16_ENSEMBLE_GROWER")
    with pytest.raises(ValueError, match="must be hist|exact"):
        _engine(grower="approx")
