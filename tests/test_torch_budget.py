"""The sweep's budget pre-flight (``parallel/sweep.py::PlanOverBudget``,
``_preflight_plan_budget``) and the memory envelope behind it
(``parallel/envelope.py``), on the CPU.

Held: an unset, empty or non-positive ``F16_DEVICE_BUDGET_MB`` computes
nothing; the refusal's text equals the JAX package's, byte for byte, for
the same plans and envelopes at budgets below, between and above the
plans; a refused grid dispatches no plan and journals no plan member,
after the configs with journaled folds have run, as in the JAX package;
the CPU law bounds the audit recorder's peak of every plan window from
above, within ``LAW_FACTOR``; the law rises with the rows, the trees and
the window width, and a dispatch bound lowers it; the ``scores planner``
and ``resume planner`` verbs refuse with the message."""

import functools
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from flake16_framework_tpu.analysis import ir as jir
from flake16_framework_tpu.parallel import planner as jplanner
from flake16_framework_tpu.parallel import sweep as jsweep
from flake16_framework_tpu_torch import __main__ as tmain
from flake16_framework_tpu_torch import config as cfg
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch.analysis import ir
from flake16_framework_tpu_torch.kernels.build import launch_counts
from flake16_framework_tpu_torch.parallel import envelope, planner, sweep
from flake16_framework_tpu_torch.resilience import journal as rjournal
from flake16_framework_tpu_torch.utils.synth import make_tests_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DEPTH = 120, 8
TREES = {"Random Forest": 2, "Extra Trees": 2}
# The CPU law over the recorder's peak at n = 120, 2 trees, depth 8: at
# least 1 for every plan window (an upper bound), and within this factor
# (read: 1.007-1.072 over the whole grid).
LAW_FACTOR = 1.10
GRID = [tuple(k) for k in cfg.iter_config_keys()]


def _one_a_family():
    """The first config of each of the six families."""
    first = {}
    for keys in GRID:
        first.setdefault((keys[1], keys[4]), keys)
    return list(first.values())


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """No database, no pinned width, one intra-op thread."""
    monkeypatch.setenv("F16_PERFDB", "0")
    monkeypatch.setenv("F16_FAULT_BACKOFF_S", "0")
    monkeypatch.delenv("F16_DEVICE_BUDGET_MB", raising=False)
    monkeypatch.delenv("F16_HIST_NODE_BATCH_CPU", raising=False)
    monkeypatch.delenv("F16_HIST_NODE_BATCH", raising=False)
    monkeypatch.delenv("F16_ENSEMBLE_GROWER", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with jax.enable_x64(False):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return ir.audit_data(N)


def _engine(data, **kw):
    return sweep.SweepEngine(*data, max_depth=DEPTH, tree_overrides=TREES,
                             device="cpu", planner_mode=True, **kw)


def _plans(configs=GRID):
    return planner.plan_grid(configs, n=N, n_folds=10,
                             tree_overrides=TREES)


def _envelope(plan, device_type="cpu"):
    return sweep.plan_envelope(plan, n_projects=26, max_depth=DEPTH,
                               grower=None, device_type=device_type)


# -- (1) unset is a no-op --------------------------------------------------


@pytest.mark.parametrize("raw", [None, "", "0", "-5", "-0.5"])
def test_unset_budget_computes_nothing(monkeypatch, data, raw):
    if raw is not None:
        monkeypatch.setenv("F16_DEVICE_BUDGET_MB", raw)

    def boom(*args, **kwargs):
        raise AssertionError("an envelope was computed")

    monkeypatch.setattr(envelope, "plan_envelope", boom)
    monkeypatch.setattr(envelope, "member_envelope", boom)
    assert sweep._preflight_plan_budget(
        _plans(), n_projects=26, max_depth=DEPTH, grower=None,
        device_type="cpu") is None
    keys = ("NOD", "Flake16", "None", "None", "Decision Tree")
    assert set(_engine(data).run_grid([keys])) == {keys}


# -- (2) the refusal's text, byte for byte ---------------------------------


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_message_equals_jax(monkeypatch, device_type):
    plans = _plans()
    jplans = jplanner.plan_grid(GRID, n=N, n_folds=10, tree_overrides=TREES)
    assert [(p.family, p.configs, p.indices, p.shape, p.batch)
            for p in plans] == [(p.family, p.configs, p.indices, p.shape,
                                 p.batch) for p in jplans]
    env = {p.family: _envelope(p, device_type) for p in plans}
    monkeypatch.setattr(jir, "trace_plan_program", lambda pl, **kw: pl)
    monkeypatch.setattr(jir, "memory_envelope", lambda pl: env[pl.family])
    mb = sorted(e["peak_bytes"] / 2**20 for e in env.values())
    assert mb[0] < mb[-1]
    budgets = [mb[0] / 2, (mb[0] + mb[1]) / 2, (mb[2] + mb[3]) / 2,
               (mb[-2] + mb[-1]) / 2, mb[-1] * 2, mb[-1]]
    refused = 0
    for budget in budgets:
        monkeypatch.setenv("F16_DEVICE_BUDGET_MB", repr(budget))
        texts = []
        for run in (
                lambda: jsweep._preflight_plan_budget(
                    jplans, n_projects=26, max_depth=DEPTH, grower=None),
                lambda: sweep._preflight_plan_budget(
                    plans, n_projects=26, max_depth=DEPTH, grower=None,
                    device_type=device_type)):
            try:
                run()
                texts.append(None)
            except ValueError as e:
                assert type(e).__name__ == "PlanOverBudget"
                texts.append(str(e))
        assert texts[0] == texts[1]
        refused += texts[1] is not None
        if texts[1] is not None:
            over = [p for p in plans
                    if env[p.family]["peak_bytes"] / 2**20 > budget]
            assert texts[1].startswith(
                f"plan pre-flight: {len(over)} of {len(plans)} family "
                f"program(s) exceed the F16_DEVICE_BUDGET_MB={budget:g} "
                f"device budget: {'/'.join(over[0].family)} (batch=")
    assert refused == 4


# -- (3) refused before any plan dispatches --------------------------------


def test_refusal_before_dispatch(monkeypatch, tmp_path, data):
    """A tiny budget: the config with journaled folds runs first (its
    config record lands), then the pre-flight refuses every plan; no plan
    runs, K1 launches nothing and the journal holds no plan member."""
    partial = ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest")
    rest = [k for k in _one_a_family() if k != partial]
    path = str(tmp_path / "scores.pkl.journal")
    jr = rjournal.SweepJournal.open(path, "fp", warn_out=io.StringIO())
    jr.record_fold(partial, 0, b"\0" * 8, np.zeros((26, 3), np.int32))
    engine = _engine(data)
    engine.journal = jr
    ran = []
    real = sweep.SweepEngine.run_plan
    monkeypatch.setattr(sweep.SweepEngine, "run_plan",
                        lambda self, *a: ran.append(a) or real(self, *a))
    before = launch_counts()
    monkeypatch.setenv("F16_DEVICE_BUDGET_MB", "0.5")
    with pytest.raises(sweep.PlanOverBudget, match=(
            r"^plan pre-flight: 6 of 6 family program\(s\) exceed the "
            r"F16_DEVICE_BUDGET_MB=0\.5 device budget: ")):
        engine.run_grid([partial] + rest)
    jr.close()
    assert ran == []
    assert launch_counts() == before
    rep = rjournal.replay(path, fingerprint="fp", warn_out=io.StringIO())
    assert list(rep.ledger) == [partial]
    assert rep.partial == {}


# -- (4) the CPU law bounds the recorder's peaks ----------------------------


def test_law_bounds_recorded_peaks(data):
    configs = _one_a_family()
    records, opened, _ = ir.trace_plan_program(
        configs, data, device="cpu", max_depth=DEPTH, tree_overrides=TREES)
    plans = _plans(configs)
    assert opened == len(plans) == len(records) == 6
    for rec, plan in zip(records, plans):
        assert rec["entry"] == ir.plan_entry(
            "scores.plan", (*plan.family, plan.batch))
        env = _envelope(plan)
        assert env["arg_bytes"] == rec["arg_bytes"]
        ratio = env["peak_bytes"] / rec["peak_bytes"]
        assert 1.0 <= ratio <= LAW_FACTOR, (plan.family, ratio)


# -- (5) the law's shape ------------------------------------------------------


def _hist_law(n=4000, n_trees=100, width=128, dispatch=None, model="Random Forest",
              device_type="cuda"):
    keys = ("NOD", "Flake16", "Scaling", "SMOTE", model)
    plan = planner.plan_grid([keys], n=n, n_folds=10,
                             tree_overrides={model: n_trees})[0]
    return sweep.plan_envelope(
        plan, {"node_batch": width}, n_projects=26, max_depth=48,
        grower=None, device_type=device_type,
        dispatch_trees=dispatch)["peak_bytes"]


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("model", ["Random Forest", "Extra Trees"])
def test_law_rises_with_shape_and_falls_with_dispatch(device_type, model):
    law = functools.partial(_hist_law, model=model, device_type=device_type)
    assert law(n=120) < law(n=240) < law(n=1000) < law(n=4000)
    assert law(n_trees=2) < law(n_trees=10) < law(n_trees=100)
    assert law(width=8) < law(width=64) < law(width=128) < law(width=226)
    assert law(dispatch=10) < law(dispatch=25) < law(dispatch=50) < law()
    dt = ("NOD", "Flake16", "Scaling", "SMOTE", "Decision Tree")
    exact = [sweep.plan_envelope(
        planner.plan_grid([dt], n=n, n_folds=10)[0], n_projects=26,
        max_depth=48, grower=None, device_type=device_type)["peak_bytes"]
        for n in (120, 1000, 4000)]
    assert exact == sorted(set(exact))
    assert exact[-1] < law()


def test_law_at_the_cards_members():
    """The card's planner members (N = 4000, 100 trees, width 128): the
    hist members peak in their draws, five int64 words of [T, max_nodes +
    W, F] beside the node keys, ET one f32 draw more; the envelope's keys
    are the JAX package's."""
    rf = _hist_law()
    et = _hist_law(model="Extra Trees")
    words = 8 * 1000 * (16000 + 128) * 16
    assert 5 * words < rf < 6 * words
    assert et - rf == pytest.approx(words / 2, rel=0.01)
    keys = ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest")
    env = sweep.plan_envelope(
        planner.plan_grid([keys], n=4000, n_folds=10)[0], n_projects=26,
        max_depth=48, grower=None, device_type="cuda", detail=True)
    assert set(env) == {"arg_bytes", "out_bytes", "peak_bytes", "phases",
                        "config"}
    assert max(env["phases"].values()) == env["peak_bytes"] - \
        env["arg_bytes"] == env["phases"]["draws"]
    with pytest.raises(ValueError, match="window width"):
        envelope.plan_envelope(
            planner.plan_grid([keys], n=40, n_folds=10)[0], n_projects=26,
            max_depth=8, hist=True, width=None, tree_chunk=100,
            fold_chunk=10, device_type="cuda")
    with pytest.raises(ValueError, match="device type"):
        _hist_law(device_type="tpu")


# -- (6) the verbs ---------------------------------------------------------


@pytest.mark.parametrize("verb", ["scores", "resume"])
def test_cli_refuses_over_budget(monkeypatch, tmp_path, verb):
    monkeypatch.chdir(tmp_path)
    make_tests_json("tests.json", n_tests=N, n_projects=6, seed=3)
    monkeypatch.setattr(tpipe, "write_scores", functools.partial(
        tpipe.write_scores, device="cpu", max_depth=DEPTH,
        tree_overrides=TREES, progress_out=io.StringIO()))
    if verb == "resume":
        with pytest.raises(ValueError, match="no resume state"):
            tmain.main(["resume", "planner"])
        open("scores.pkl.journal", "wb").close()
    monkeypatch.setenv("F16_DEVICE_BUDGET_MB", "1")
    with pytest.raises(sweep.PlanOverBudget) as err:
        tmain.main([verb, "planner"])
    text = str(err.value)
    assert text.startswith("plan pre-flight: 6 of 6 family program(s) "
                           "exceed the F16_DEVICE_BUDGET_MB=1 device "
                           "budget: Flake16/Extra Trees (batch=36): peak ")
    for family in ("Flake16/Random Forest", "Flake16/Decision Tree",
                   "FlakeFlagger/Extra Trees", "FlakeFlagger/Random Forest",
                   "FlakeFlagger/Decision Tree"):
        assert f"; {family} (batch=36): peak " in text
    assert not os.path.exists("scores.pkl")
    rep = rjournal.replay("scores.pkl.journal", warn_out=io.StringIO())
    assert rep.ledger == {} and rep.partial == {}


_NO_TORCH = r'''
import sys
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "numpy", "jax",
                                  "flake16_framework_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Blocker())
from flake16_framework_tpu_torch.parallel import envelope, planner
from flake16_framework_tpu_torch import config as cfg
plan = planner.plan_grid([tuple(k) for k in cfg.iter_config_keys()][:1],
                         n=4000, n_folds=10)[0]
print(envelope.plan_envelope(plan, n_projects=26, max_depth=48, hist=True,
                             width=128, tree_chunk=100, fold_chunk=10,
                             device_type="cuda")["peak_bytes"])
'''


def test_envelope_imports_no_torch():
    """The law is host arithmetic: it imports neither torch nor numpy,
    nor anything of the JAX package, and gives the card's ET plan."""
    out = subprocess.run([sys.executable, "-c", _NO_TORCH], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    keys = ("NOD", "Flake16", "None", "None", "Extra Trees")
    assert int(out.stdout.split()[-1]) == sweep.plan_envelope(
        planner.plan_grid([keys], n=4000, n_folds=10)[0], n_projects=26,
        max_depth=48, grower=None, device_type="cuda")["peak_bytes"]
