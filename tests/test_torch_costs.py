"""Cost attribution in the port (``obs/costs.py``), against the JAX
package's: the grower's analytic stage flops (``fit_stage_flops``) equal
the JAX package's dict for dict; a telemetry run of each package's hist
fit on the same seeded inputs stamps equal ``stage_flops`` on its ``cost``
event; ``report --attrib`` on a port ``scores`` run splits the fit into
the four grower sub-stages in the JAX package's proportions; the perfdb
gives a port run kernel cost rows; K1's and K2's ``work`` equal the
formulas of the bounds that ``chip_smoke.py`` reports; and the dispatch
census over ``scores planner`` and ``shap`` on a small grid is held
against the JAX package's ``dispatch_stats()`` delta on the same grid."""

import collections
import io
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from flake16_framework_tpu import pipeline as jpipe
from flake16_framework_tpu.obs import aot as jaot
from flake16_framework_tpu.obs import report as jreport
from flake16_framework_tpu.ops import trees as jtrees
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch.kernels import hist, treeshap_unit
from flake16_framework_tpu_torch.obs import aot, costs
from flake16_framework_tpu_torch.obs import perfdb as tperfdb
from flake16_framework_tpu_torch.obs import report as treport
from flake16_framework_tpu_torch.ops import trees as ttrees
from flake16_framework_tpu_torch.utils.synth import make_tests_json
from torch_hist_cases import hist_inputs
from torch_obs_cases import observed

SUB = ("bin", "hist_build", "split_scan", "partition")
RF = ("NOD", "Flake16", "None", "SMOTE", "Random Forest")


@pytest.fixture(autouse=True)
def _jax_x64_off(monkeypatch):
    monkeypatch.setenv("F16_PERFDB", "0")
    monkeypatch.delenv("F16_HIST_NODE_BATCH_CPU", raising=False)
    monkeypatch.delenv("F16_ENSEMBLE_GROWER", raising=False)
    with jax.enable_x64(False):
        yield


@pytest.mark.parametrize("kw", [
    dict(n=120, n_feat=16, n_bins=64, n_trees=3, n_nodes=240, max_nodes=240,
         node_batch=8),
    dict(n=480, n_feat=7, n_bins=64, n_trees=40, n_nodes=1000,
         max_nodes=1920, node_batch=16),
    dict(n=8000, n_feat=16, n_bins=64, n_trees=1000, n_nodes=16000,
         max_nodes=16000, node_batch=128),
    dict(n=8000, n_feat=16, n_bins=32, n_trees=100, n_nodes=50,
         max_nodes=16000, node_batch=226),
])
def test_fit_stage_flops_equal_jax(kw):
    assert ttrees.fit_stage_flops(**kw) == jtrees.fit_stage_flops(**kw)


def test_fit_stage_flops_default_width_is_the_growers():
    kw = dict(n=480, n_feat=16, n_bins=64, n_trees=4, n_nodes=960,
              max_nodes=960)
    for dev in ("cpu", "cuda"):
        assert ttrees.fit_stage_flops(**kw, device_type=dev) == \
            ttrees.fit_stage_flops(
                **kw, node_batch=ttrees.default_node_batch(dev))


def _hist_fit_inputs(n=200, n_feat=6, seed=3):
    rs = np.random.RandomState(seed)
    x = rs.lognormal(size=(n, n_feat)).astype(np.float32)
    y = rs.rand(n) < 0.3
    w = np.ones(n, np.float32)
    return x, y, w


def _costs_of(run, span):
    return [e for e in run.of("cost") if e["span"] == span]


def test_hist_fit_cost_events_carry_jax_stage_flops(tmp_path, monkeypatch):
    """The same seeded hist fit through each package's
    ``trees.fit_forest_hist`` with telemetry on: one ``cost`` event each,
    with equal ``stage_flops``; the port's flops and bytes are its
    counting pass's (nonzero), and a second call of the signature emits
    nothing more."""
    x, y, w = _hist_fit_inputs()
    kw = dict(n_trees=3, bootstrap=True, random_splits=False,
              sqrt_features=True, max_depth=8)
    with observed("jax", tmp_path / "jax", monkeypatch) as jr:
        jtrees.fit_forest_hist(x, y, w, jax.random.PRNGKey(4), **kw)
    with observed("torch", tmp_path / "torch", monkeypatch) as tr:
        from flake16_framework_tpu_torch import rng

        args = (torch.from_numpy(x), torch.from_numpy(y),
                torch.from_numpy(w), rng.prng_key(4, "cpu"))
        ttrees.fit_forest_hist(*args, **kw)
        ttrees.fit_forest_hist(*args, **kw)
    (jev,) = _costs_of(jr[0], "trees.fit_forest_hist")
    (tev,) = _costs_of(tr[0], "trees.fit_forest_hist")
    assert tev["stage_flops"] == jev["stage_flops"]
    assert set(tev["stage_flops"]) == set(SUB)
    assert tev["flops"] > 0 and tev["bytes"] > 0 and tev["compile_s"] == 0
    assert tr[0].invalid() == []


@pytest.mark.parametrize("model", ["Random Forest", "Decision Tree"])
def test_pass_flops_equal_flop_counter_mode(model):
    """The counting pass's flops on the CPU (no kernel launches) are
    ``FlopCounterMode``'s count of the same call: a resample through the
    kNN balancer, then a fit on either grower (the plain K1's contraction
    on the histogram grower)."""
    from torch.utils.flop_counter import FlopCounterMode

    from flake16_framework_tpu_torch import rng
    from flake16_framework_tpu_torch.config import BALANCINGS
    from flake16_framework_tpu_torch.ops.resample import resample

    x, y, w = (torch.from_numpy(a) for a in _hist_fit_inputs())
    kw = dict(n_trees=3 if model == "Random Forest" else 1,
              bootstrap=model == "Random Forest", random_splits=False,
              sqrt_features=model == "Random Forest", max_depth=8)
    fit = ttrees.fit_forest_hist if model == "Random Forest" \
        else ttrees.fit_forest

    def call():
        kb, kf = rng.split(rng.prng_key(4, "cpu")).unbind(0)
        xs, ys, ws = resample(x, y, w, BALANCINGS["SMOTE Tomek"], kb,
                              2 * x.shape[0])
        return fit(xs, ys, ws, kf, **kw)

    with FlopCounterMode(display=False) as fc:
        call()
    with costs.counting_pass() as p:
        call()
    assert p.flops == fc.get_total_flops() > 0
    assert p.bytes > 0


@pytest.fixture(scope="module")
def scores_runs(tmp_path_factory):
    """{"jax": Run, "torch": Run} of the same staged ``scores`` run (one
    3-tree Random Forest config, N = 120), telemetry on."""
    d = tmp_path_factory.mktemp("costs")
    tj = str(d / "tests.json")
    make_tests_json(tj, n_tests=120, n_projects=4, seed=5)
    kw = dict(configs=[RF], max_depth=8, tree_overrides={"Random Forest": 3},
              progress_out=io.StringIO())
    mp = pytest.MonkeyPatch()
    mp.setenv("F16_PERFDB", "0")
    out = {}
    try:
        with jax.enable_x64(False):
            with observed("jax", d / "jax", mp) as r:
                jpipe.write_scores(tj, str(d / "j.pkl"), **kw)
            out["jax"] = r[0]
        with observed("torch", d / "torch", mp) as r:
            tpipe.write_scores(tj, str(d / "t.pkl"), device="cpu", **kw)
        out["torch"] = r[0]
    finally:
        mp.undo()
    return out


def _shares(stages):
    fit = {s: stages[f"fit.{s}"] for s in SUB}
    total = sum(fit.values())
    return {s: v / total for s, v in fit.items()}


def test_attrib_splits_the_port_fit_in_jax_proportions(scores_runs):
    """``report --attrib`` on each run: the port's fit stage splits into
    the four ``fit.*`` sub-stages, in the proportions of the JAX
    package's on its own run of the config (both from the ``scores.fit``
    cost event's ``stage_flops``, which are equal)."""
    jrun, trun = scores_runs["jax"], scores_runs["torch"]
    (jev,) = _costs_of(jrun, "scores.fit")
    (tev,) = _costs_of(trun, "scores.fit")
    assert tev["stage_flops"] == jev["stage_flops"]
    at = treport.summarize_attrib(trun.manifest, trun.events)
    jat = jreport.summarize_attrib(jrun.manifest, jrun.events)
    assert {f"fit.{s}" for s in SUB} <= set(at["stages"])
    assert "fit" not in at["stages"]
    want = _shares(jat["stages"])
    for s, v in _shares(at["stages"]).items():
        assert v == pytest.approx(want[s], abs=2e-3), s
    text = treport.render_attrib(at)
    assert "fit.hist_build" in text and "scores.fit" in text


def test_perfdb_rows_from_a_port_run_carry_kernel_costs(scores_runs):
    """The perfdb gives a port run one ``kernel.<span>`` row an
    instrumented entry point, from its ``cost`` aggregate, as it gives a
    JAX package run."""
    rows = {r["kernel"]: r
            for r in tperfdb.rows_from_run(scores_runs["torch"].dir)}
    fit = rows["kernel.scores.fit"]["metrics"]
    assert set(fit) == {"flops", "bytes", "compile_s", "n"}
    assert fit["n"] == 1 and fit["flops"] > 0 and fit["bytes"] > 0
    assert rows["kernel.scores.score"]["metrics"]["n"] == 1
    assert {f"stage.fit.{s}" for s in SUB} <= set(rows)
    jrows = {r["kernel"] for r in
             tperfdb.rows_from_run(scores_runs["jax"].dir)}
    assert {"kernel.scores.fit", "kernel.scores.score_folds"} <= jrows


@pytest.mark.parametrize("case", [
    dict(seed=1, n_tree=3, n=600, n_feat=5, n_nodes=4, n_bins=16),
    dict(seed=2, n_tree=7, n=1000, n_feat=16, n_nodes=128, n_bins=64),
])
def test_hist_work_equals_the_bound_formulas(case):
    """K1's ``work``: each input read once and both outputs written once;
    two adds an in-window sample of weight > 0 and feature, two an output
    element; ``chip_smoke.hist_bound_ms`` is its larger time."""
    rel, w, wy, bins, n_nodes, n_bins = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in hist_inputs(**case))
    got = hist.work(rel, w, bins, n_nodes, n_bins)
    t, n = rel.shape
    f = bins.shape[-2]
    live = int(((rel >= 0) & (rel < n_nodes) & (w > 0)).sum())
    out = t * f * n_nodes * n_bins
    assert got == {"flops": 2.0 * f * live + 2 * out,
                   "bytes": float(t * n * 12 + bins.numel() + 8 * out)}
    ms, by = chip_smoke.hist_bound_ms(rel, w, bins, n_nodes, n_bins)
    b_ms = got["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
    o_ms = got["flops"] / chip_smoke.F32_OPS_PER_S * 1e3
    assert ms == max(b_ms, o_ms)
    assert by == ("bytes" if b_ms >= o_ms else "operations")


def test_unit_work_equals_the_bound_formulas():
    """K2's ``work``: u^2 + 7u + 1 operations a (work item, sample) and 4u
    a (live slot, sample) pair with o = 1; each input read once and phi
    written once."""
    rs = np.random.RandomState(0)
    r, cap, s, f = 40, 8, 24, 7
    fid = torch.from_numpy(np.stack([rs.permutation(f)[:cap] if cap <= f
                                     else rs.permutation(cap)
                                     for _ in range(r)]).astype(np.int32)
                           % f)
    u = torch.from_numpy(rs.randint(1, min(cap, f) + 1, r).astype(np.int32))
    lo = torch.from_numpy(rs.uniform(-1, 0, (r, cap)).astype(np.float32))
    hi = lo + torch.from_numpy(rs.uniform(0, 2, (r, cap)).astype(np.float32))
    z = torch.from_numpy(rs.uniform(0, 1, (r, cap)).astype(np.float32))
    scale = torch.from_numpy(rs.uniform(0, 1, r).astype(np.float32))
    x = torch.from_numpy(rs.uniform(-1, 1, (s, f)).astype(np.float32))
    got = treeshap_unit.work(fid, z, lo, hi, u, scale, x)
    n1 = np.zeros(r)
    xs = x.numpy()
    for i in range(r):
        for k in range(int(u[i])):
            col = xs[:, int(fid[i, k])]
            n1[i] += ((col > float(lo[i, k])) & (col <= float(hi[i, k]))).sum()
    uu = u.numpy().astype(np.float64)
    assert got["flops"] == pytest.approx(
        float((uu * uu + 7 * uu + 1).sum() * s + (4 * uu * n1).sum()),
        rel=1e-12)
    assert got["bytes"] == float(4 * (4 * r * cap + 2 * r) + 8 * s * f)


def test_jax_and_port_runs_validate(scores_runs):
    for run in scores_runs.values():
        assert run.invalid() == []
        assert run.of("cost")
    assert scores_runs["torch"].manifest["jax_cache_misses"] == 0
    assert os.path.basename(
        scores_runs["torch"].manifest["kernel_build_dir"]) == "_build"


CENSUS_CONFIGS = [
    ("NOD", "Flake16", "None", "None", "Decision Tree"),
    ("OD", "Flake16", "Scaling", "None", "Decision Tree"),
    ("NOD", "Flake16", "None", "None", "Extra Trees"),
]
TINY = {"Extra Trees": 4, "Random Forest": 4}


def _census(module, stats, fn):
    """(dispatch delta, calls by entry name) of ``fn()``."""
    calls = collections.Counter()
    real = module.__call__

    def call(self, *a, **k):
        calls[getattr(self, "name", None) or self._name] += 1
        return real(self, *a, **k)

    module.__call__ = call
    try:
        before = stats()
        fn()
        after = stats()
    finally:
        module.__call__ = real
    return after["dispatches"] - before["dispatches"], dict(calls)


def test_dispatch_census_against_jax(tmp_path):
    """``scores planner`` and ``shap`` on a small grid (N = 120, two
    family plans, one of two members; the two paper SHAP configs) in both
    packages.

    ``scores.plan_batch`` is one a plan in both. The JAX package's other
    counts in the planner run, ``trees.fit_forest_hist`` and
    ``trees.fit_forest`` once a plan of their grower and
    ``trees.predict_proba`` once a plan, are the traces of each plan's one
    program body, not dispatches of their own; the port runs a plan's
    members through its fold-batched growers (``fit_folds_hist``,
    ``fit_folds``, ``predict_batch``), which are not entry points, so it
    counts none. In ``shap`` the grower, ``shap.compact`` and the unit (the
    JAX package's xla arm on the CPU, the port's ``shap.unit_pallas``, one
    a bucket) map one to one; the port also counts ``shap.fused_fit``, its
    one host call of the fit chain (the JAX package's staged path has no
    fused program), one a config."""
    tj = str(tmp_path / "tests.json")
    make_tests_json(tj, n_tests=120, n_projects=4, seed=11)
    kw = dict(configs=CENSUS_CONFIGS, max_depth=8, tree_overrides=TINY,
              progress_out=io.StringIO())
    j_plan = _census(jaot.AotExecutableCache, jaot.dispatch_stats,
                     lambda: jpipe.write_scores(
                         tj, str(tmp_path / "j.pkl"), planner=True, **kw))
    t_plan = _census(costs._Instrumented, aot.dispatch_stats,
                     lambda: tpipe.write_scores(
                         tj, str(tmp_path / "t.pkl"), planner=True,
                         device="cpu", **kw))
    assert j_plan[1] == {"scores.plan_batch": 2, "trees.fit_forest_hist": 1,
                         "trees.fit_forest": 1, "trees.predict_proba": 2}
    assert j_plan[0] == sum(j_plan[1].values())
    assert t_plan == (2, {"scores.plan_batch": 2})
    skw = dict(max_depth=8, tree_overrides=TINY)
    j_shap = _census(jaot.AotExecutableCache, jaot.dispatch_stats,
                     lambda: jpipe.write_shap(tj, str(tmp_path / "j.shap"),
                                              **skw))
    t_shap = _census(costs._Instrumented, aot.dispatch_stats,
                     lambda: tpipe.write_shap(tj, str(tmp_path / "t.shap"),
                                              device="cpu", **skw))
    j_units = sum(v for k, v in j_shap[1].items() if k.startswith(
        "shap.unit_"))
    assert t_shap[1] == {
        "shap.fused_fit": 2,
        "trees.fit_forest_hist": j_shap[1]["trees.fit_forest_hist"],
        "shap.compact": j_shap[1]["shap.compact"],
        "shap.unit_pallas": j_units}
    assert t_shap[0] == j_shap[0] + 2
