"""The port's config-batched sweep across a device list (the JAX package's
mesh path): ``SweepEngine(devices=...)``, ``run_config_batch``,
``run_grid(batch_size=)``, plans split over the cards, and the hist
grower's per-group bin edges. On the CPU a device list that repeats
``cpu`` stands in for several cards, as the JAX tests' eight virtual
devices do for a mesh. Grades: counts bitwise equal to the port's
per-config path and, without PCA, equal to the JAX package's mesh path
on the same data; forests bitwise group by group; journal records equal
record for record."""

import io
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from flake16_framework_tpu.config import iter_config_keys
from flake16_framework_tpu.parallel import sweep as jsweep
from flake16_framework_tpu.utils.synth import make_dataset, make_tests_json
from flake16_framework_tpu_torch import device as tdevice
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch import rng
from flake16_framework_tpu_torch.ops import trees
from flake16_framework_tpu_torch.parallel import planner as tplanner
from flake16_framework_tpu_torch.parallel import sweep as tsweep
from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
from flake16_framework_tpu_torch.resilience import inject
from flake16_framework_tpu_torch.resilience import journal as tjournal

from torch_obs_cases import observed

N_TESTS, N_PROJECTS, DEPTH = 240, 6, 8
TINY = {"Extra Trees": 4, "Random Forest": 4}
GRID = [tuple(k) for k in iter_config_keys()]

# Five Decision Trees, so a batch on three "cards" is padded (5 on 3).
DT = [("NOD", "Flake16", p, b, "Decision Tree") for p, b in (
    ("None", "None"), ("Scaling", "None"), ("None", "SMOTE"),
    ("None", "Tomek Links"), ("Scaling", "ENN"))]
# Two configs a family with different preprocessing, so different edges.
RF = [("NOD", "Flake16", "None", "None", "Random Forest"),
      ("OD", "Flake16", "Scaling", "SMOTE", "Random Forest")]
ET = [("NOD", "Flake16", "None", "SMOTE", "Extra Trees"),
      ("OD", "Flake16", "Scaling", "None", "Extra Trees")]
ALL = DT + RF + ET


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs several
    workers on the machine's cores (and this module's card workers are
    threads of their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_x64_off(monkeypatch):
    """The JAX package as it runs in production, with 64-bit mode off."""
    monkeypatch.setenv("F16_FAULT_BACKOFF_S", "0")
    monkeypatch.setenv("F16_PERFDB", "0")
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
    if "devices" not in kw:
        kw["device"] = "cpu"
    return SweepEngine(*_arrays(), max_depth=DEPTH, tree_overrides=TINY,
                       **kw)


def _same(got, want, configs):
    for k in configs:
        assert pickle.dumps(got[k][2:]) == pickle.dumps(want[k][2:]), k


@pytest.fixture(scope="module")
def per_config():
    """The port's per-config path (folds one after another) on ALL."""
    return _engine().run_grid(ALL)


@pytest.fixture(scope="module")
def jax_mesh():
    """The JAX package's mesh path on the same data: the five Decision
    Trees as one batch over the eight virtual devices, RF and ET in
    batches of two."""
    with jax.enable_x64(False):
        eng = jsweep.SweepEngine(*_arrays(), max_depth=DEPTH,
                                 tree_overrides=TINY,
                                 mesh=jsweep.default_mesh())
        out = eng.run_grid(DT)
        out.update(eng.run_grid(RF + ET, batch_size=2))
    assert set(eng.amortized_configs) == set(ALL)
    return out


@pytest.fixture(scope="module")
def tests_json(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "tests.json"
    make_tests_json(str(path), n_tests=N_TESTS, n_projects=N_PROJECTS,
                    seed=11)
    return str(path)


# -- the device list -------------------------------------------------------


def test_device_lists():
    cpu = torch.device("cpu")
    assert tdevice.resolve_devices(["cpu"] * 3) == [cpu] * 3
    with pytest.raises(ValueError):
        tdevice.resolve_devices([])
    if not torch.cuda.is_available():
        for bad in (["cuda:0"], ["cpu", "cuda"], None):
            with pytest.raises((RuntimeError, ValueError)):
                tdevice.resolve_devices(bad)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdevice.default_devices()
    with pytest.raises(ValueError, match="not both"):
        _engine(devices=["cpu"], device="cpu")
    eng = _engine(devices=["cpu"] * 2)
    assert eng.devices == [cpu] * 2 and len(eng._cards) == 2
    assert eng._cards[0].features is not eng._cards[1].features


@pytest.mark.parametrize("width", [1, 2, 3, 8, 40])
def test_family_batches_equal_jax(width):
    shuffled = GRID[::7] + GRID[3::11]
    assert list(tsweep.iter_family_batches(shuffled, width)) == \
        [[tuple(k) for k in b]
         for b in jsweep.iter_family_batches(shuffled, width)]


@pytest.mark.parametrize("n_trees,hist,n_configs,dispatch,want", [
    (100, True, 1, (None, None), (100, 10)),    # one config: as before
    (100, True, 2, (None, None), (50, 20)),     # 2 x 10 x 50 = 1,000
    (100, True, 4, (None, None), (25, 40)),
    (1, False, 4, (None, None), (1, 200)),      # 4 DTs x 10 folds, one batch
    (1, False, 21, (None, None), (1, 200)),
    (100, True, 2, (30, 3), (30, 6)),           # dispatch_folds a config
])
def test_trees_in_flight_over_configs(n_trees, hist, n_configs, dispatch,
                                      want):
    assert tsweep.batch_bounds(n_trees, hist, *dispatch,
                               n_configs=n_configs) == want


# -- the hist grower's per-group edges -------------------------------------


@pytest.mark.parametrize("model,folds", [("Random Forest", 5),
                                         ("Extra Trees", None)])
def test_per_group_edges_equal_one_config_calls(model, folds):
    """Two configs' folds (different preprocessing, so different edges)
    grown as one tree batch with [G, F, B-1] edges: each group's forest
    equals its config's own call with shared [F, B-1] edges, bit for
    bit, also in batches of ``folds`` folds a config (each batch then
    slices the edges with its groups)."""
    eng = SweepEngine(*_arrays(), max_depth=DEPTH, device="cpu",
                      tree_overrides={model: 2})
    configs = RF if model == "Random Forest" else ET
    card = eng._cards[0]
    fits, parts = {}, []
    for keys in configs:
        forest, preps = eng._fit_groups([keys], card)
        fits[keys] = forest
        parts.append(preps[0])
    assert not torch.equal(parts[0]["edges"], parts[1]["edges"])
    calls = []
    real = trees.fit_folds_hist

    def spy(x, *a, edges, **kw):
        calls.append((x.shape[0], edges.shape, kw["fold_chunk"]))
        return real(x, *a, edges=edges, **kw)

    trees.fit_folds_hist = spy
    try:
        eng.dispatch_folds = folds
        both, _ = eng._fit_groups(configs, card)
    finally:
        trees.fit_folds_hist = real
    assert calls == [(20, (20, 16, 63), 10 if folds else 500)]
    for c, keys in enumerate(configs):
        for name in trees.Forest._fields[:-1]:
            got = getattr(both, name)[c * 10:(c + 1) * 10]
            assert torch.equal(got, getattr(fits[keys], name)), (keys, name)


# -- run_grid over a device list --------------------------------------------


def test_padded_dt_batch_equals_per_config_and_jax(per_config, jax_mesh):
    """Five Decision Trees on three "cards": one batch padded to six,
    shards of two (the third card's holds the pad); counts equal the
    port's per-config path bitwise and the JAX mesh path's; every
    config's clocks are batch-amortized."""
    eng = _engine(devices=["cpu"] * 3)
    batches, shards = [], []
    real, real_fit = eng.run_config_batch, eng._fit_groups
    eng.run_config_batch = lambda b: batches.append(b) or real(b)
    eng._fit_groups = lambda configs, card, **kw: shards.append(
        (eng._cards.index(card), configs)) or real_fit(configs, card, **kw)
    got = eng.run_grid(DT, batch_size=5)
    assert batches == [DT]
    assert sorted(shards) == [(0, DT[:2]), (1, DT[2:4]), (2, [DT[4], DT[0]])]
    _same(got, per_config, DT)
    _same(got, jax_mesh, DT)
    assert eng.amortized_configs == set(DT) and not eng.fused_configs
    assert all(len(v) == 4 and v[1] > 0 for v in got.values())


@pytest.mark.parametrize("devices,fused", [(["cpu"], False),
                                           (["cpu"] * 2, True)])
def test_rf_et_batches_equal_per_config_and_jax(per_config, jax_mesh,
                                                devices, fused):
    """An RF and an ET batch of two configs with different preprocessing,
    on one card (both configs on the group axis: batch_size=2) and split
    over two (fused): equal to the port's per-config path bitwise and to
    the JAX package's counts."""
    eng = _engine(devices=devices, fused=fused)
    got = eng.run_grid(RF + ET, batch_size=2)
    _same(got, per_config, RF + ET)
    _same(got, jax_mesh, RF + ET)
    assert eng.amortized_configs == set(RF + ET)
    assert eng.fused_configs == (set(RF + ET) if fused else set())
    if fused:
        assert all(v[1] == 0.0 for v in got.values())


def _fold_records(monkeypatch):
    """Every fold record the journal writes, as (keys, fold, key bytes,
    counts bytes), and the config records' keys."""
    folds, configs = [], []
    real_fold = tjournal.SweepJournal.record_fold
    real_config = tjournal.SweepJournal.record_config

    def fold(self, keys, f, kb, counts, **kw):
        folds.append((tuple(keys), f, bytes(kb),
                      np.asarray(counts, np.int32).tobytes(),
                      kw.get("config_index")))
        return real_fold(self, keys, f, kb, counts, **kw)

    def config(self, keys, result):
        configs.append(tuple(keys))
        return real_config(self, keys, result)

    monkeypatch.setattr(tjournal.SweepJournal, "record_fold", fold)
    monkeypatch.setattr(tjournal.SweepJournal, "record_config", config)
    return folds, configs


def test_journaled_batch_writes_the_per_config_records(tests_json, tmp_path,
                                                       monkeypatch):
    """A journaled batch (``write_scores(devices=...)``, staged) writes
    the fold records of the per-config path, record for record, each
    config's folds then its config record; the pickles' scores equal."""
    folds, configs = _fold_records(monkeypatch)
    kw = dict(configs=DT, max_depth=DEPTH, progress_out=io.StringIO())
    one = tpipe.write_scores(tests_json, str(tmp_path / "one.pkl"),
                             device="cpu", **kw)
    want = (sorted(folds), list(configs))
    del folds[:], configs[:]
    got = tpipe.write_scores(tests_json, str(tmp_path / "batch.pkl"),
                             devices=["cpu"] * 2, **kw)
    assert sorted(folds) == want[0] and configs == want[1]
    order = [(k, f) for k, f, *_ in folds]
    assert order == [(k, f) for k in DT for f in range(10)]
    _same(got, one, DT)
    with open(str(tmp_path / "batch.pkl.meta.json")) as fd:
        meta = json.load(fd)
    assert sorted(map(tuple, meta["batch_amortized"])) == sorted(DT[:4])


def test_killed_plan_over_two_cards_resumes(tests_json, tmp_path,
                                            monkeypatch):
    """A ``planner`` sweep whose Decision Tree plan is split over two
    "cards", killed right after the first member's ten folds are
    journaled, resumes to the uninterrupted run's ``scores.pkl``: the
    journal held a prefix of the members in canonical order."""
    configs = DT[:4]
    kw = dict(configs=configs, max_depth=DEPTH, planner=True,
              devices=["cpu"] * 2)
    ref = tpipe.write_scores(tests_json, str(tmp_path / "ref.pkl"),
                             progress_out=io.StringIO(), **kw)
    out = str(tmp_path / "scores.pkl")
    seen = []
    real = tjournal.SweepJournal.record_fold

    def killed(self, keys, *a, **k):
        out_ = real(self, keys, *a, **k)
        seen.append(tuple(keys))
        if len(seen) == 10:
            raise KeyboardInterrupt
        return out_

    monkeypatch.setattr(tjournal.SweepJournal, "record_fold", killed)
    with pytest.raises(KeyboardInterrupt):
        tpipe.write_scores(tests_json, out, progress_out=io.StringIO(), **kw)
    monkeypatch.setattr(tjournal.SweepJournal, "record_fold", real)
    assert seen == [configs[0]] * 10
    rep = tjournal.replay(tjournal.journal_path(out), warn_out=None)
    assert not rep.ledger and set(rep.partial) == {configs[0]}
    log = io.StringIO()
    resumed = tpipe.write_scores(tests_json, out, progress_out=log, **kw)
    assert "replayed 0 completed config(s) and 10 partial" in log.getvalue()
    _same(resumed, ref, configs)
    with open(out, "rb") as fd:
        _same(pickle.load(fd), ref, configs)
    assert not os.path.exists(tjournal.journal_path(out))


def test_device_faults_force_width_one(per_config, monkeypatch):
    """An injection plan with a device fault forces width 1: no batch
    runs, the faulted config retries alone and every count is equal."""
    monkeypatch.setenv(inject.ENV_VAR, f"{GRID.index(DT[1])}:1:transient")
    eng = _engine(devices=["cpu"] * 2)
    eng.run_config_batch = None             # never called
    got = eng.run_grid(DT[:3], batch_size=3)
    _same(got, per_config, DT[:3])
    assert [r["label"] for r in eng.retries] == ["/".join(DT[1])]
    assert not eng.amortized_configs


def test_abandoned_batch_salvaged_config_by_config(tests_json, tmp_path,
                                                   per_config, monkeypatch):
    """A batch the guard abandons (a deterministic fault) is salvaged
    config by config on the per-config path: nothing is quarantined,
    counts are equal, and the salvage is in ``retries`` and printed."""
    def broken(self, batch):
        raise RuntimeError("shape mismatch in the batch (injected)")

    monkeypatch.setattr(SweepEngine, "run_config_batch", broken)
    log = io.StringIO()
    got = tpipe.write_scores(tests_json, str(tmp_path / "s.pkl"),
                             configs=DT[:3], max_depth=DEPTH,
                             devices=["cpu"] * 3, progress_out=log)
    _same(got, per_config, DT[:3])
    assert "SALVAGED batch/Flake16/Decision Tree [deterministic]: 3 " \
        "config(s) run one by one" in log.getvalue()

    eng = _engine(devices=["cpu"] * 3)
    got = eng.run_grid(DT[:3])
    assert not eng.quarantined and not eng.amortized_configs
    assert [(r["label"], r["salvaged"], r["fault_class"])
            for r in eng.retries] == [
        ("batch/Flake16/Decision Tree", 3, "deterministic")]


def test_plan_over_two_cards_equals_one_card(per_config):
    """``planner_mode`` over two "cards" (plans padded to 2, each card its
    shard's members in turn): scores bitwise equal to the one-card plan
    and to the per-config path, the same clock provenance, and each
    plan member on the card of its contiguous shard."""
    configs = DT[:3] + RF + ET[:1]          # plans of 3, 2 and 1 members
    one = _engine(planner_mode=True)
    want = one.run_grid(configs)
    two = _engine(devices=["cpu"] * 2, planner_mode=True)
    cards = []
    real = two._fit_count_folds

    def fit(keys, card=None, **kw):
        cards.append((keys, two._cards.index(card)))
        return real(keys, card=card, **kw)

    two._fit_count_folds = fit
    got = two.run_grid(configs)
    _same(got, want, configs)
    _same(got, per_config, configs)
    assert two.fused_configs == one.fused_configs == set(configs)
    assert two.amortized_configs == one.amortized_configs
    placed = dict(cards)
    plans = tplanner.plan_grid(configs, devices=2, n=N_TESTS, n_folds=10,
                               tree_overrides=TINY)
    assert sorted(p.batch for p in plans) == [2, 2, 4]
    for p in plans:
        assert [placed[k] for k in p.configs] == [
            i // (p.batch // 2) for i in range(len(p.configs))]


# -- telemetry ---------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_batch_spans_and_manifest(tests_json, tmp_path, monkeypatch, fused):
    """``write_scores(devices=[cpu, cpu])`` batches by default (width =
    the card count): the staged batch spans (``scores.fit_batch`` and
    ``scores.score_batch``) or the fused ``scores.config_batch``, with
    the JAX package's fields and the fit spans' K1/K2 launch counts; the
    manifest's ``device_count`` 2 and ``mesh_shape`` {"config": 2};
    every event valid under both packages' schemas."""
    with observed("torch", tmp_path / "tel", monkeypatch) as box:
        tpipe.write_scores(tests_json, str(tmp_path / "s.pkl"),
                           configs=DT[:2] + RF, max_depth=DEPTH,
                           tree_overrides=TINY, devices=["cpu"] * 2,
                           fused=fused, progress_out=io.StringIO())
    run = box[0]
    assert run.invalid() == []
    assert run.manifest["device_count"] == 2
    assert run.manifest["mesh_shape"] == {"config": 2}
    names = ["scores.config_batch"] if fused else \
        ["scores.fit_batch", "scores.score_batch"]
    spans = [e for e in run.of("span") if e["name"].endswith("_batch")]
    assert sorted({e["name"] for e in spans}) == sorted(names)
    for e in spans:
        assert e["batch"] == 2 and len(e["configs"]) == 2
        assert e["stage"] in ("fit", "predict", "fused")
        assert e["mode"] == ("fused" if fused else "staged")
        if e["name"] != "scores.score_batch":
            assert e["k1_launches"] == 0 and e["k2_launches"] == 0
    assert ("scores.fit_batch" if not fused else "scores.config_batch",
            ("Flake16", "Random Forest", "fused" if fused else "staged",
             2)) in run.keys
    assert run.counters()["configs"] == 4


def test_key_table_is_per_card():
    """Fold keys drawn on any card equal the first card's: the keys are
    the config's, not the card's."""
    eng = _engine(devices=["cpu"] * 2)
    a = eng._fold_keys(DT[0], eng._cards[1].device)
    assert torch.equal(a, eng._fold_keys(DT[0]))
    assert torch.equal(a, rng.split(rng.fold_in(
        rng.prng_key(tsweep.SEED, "cpu"), GRID.index(DT[0])), 10))
