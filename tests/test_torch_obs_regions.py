"""The port's spans and regions on the profiler's clock, on the CPU.

Under a ``torch.profiler`` capture the grower's stages, the sweep's prep,
resample and counts, and the service's legs are ranges of the capture
(``obs.region``), and every ``obs.span`` is one as well; with neither
telemetry nor a capture on, both are the shared no-op object and reach
nothing in torch. A region never reaches the JSONL sink. The service
counts its answered requests and their queue and handoff waits whether
telemetry is on or not, and reads its gauges' values only when it is.
"""

import json
import math
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from flake16_framework_tpu_torch import obs, rng
from flake16_framework_tpu_torch.analysis import Engine, rules_obs
from flake16_framework_tpu_torch.obs import core, costs
from flake16_framework_tpu_torch.ops import trees
from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
from flake16_framework_tpu_torch.serve import ModelRegistry, ScoringService
from flake16_framework_tpu_torch.utils.synth import make_dataset

RF = ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest")
ET = ("OD", "Flake16", "Scaling", "None", "Extra Trees")
TINY = {"Random Forest": 3, "Extra Trees": 3}
N_PROJECTS = 4

SWEEP_REGIONS = ("sweep.prep", "sweep.resample", "sweep.counts",
                 "trees.draws", "trees.step", "trees.k1", "trees.split",
                 "trees.route", "trees.sync", "trees.predict")
# Each region and the span or region it opens inside.
PARENT = {"trees.k1": "trees.step", "trees.split": "trees.step",
          "trees.route": "trees.step", "trees.sync": "trees.step",
          "trees.step": "scores.plan", "trees.draws": "scores.plan",
          "sweep.prep": "scores.plan", "sweep.resample": "scores.plan",
          "trees.predict": "scores.plan", "sweep.counts": "scores.plan"}


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.delenv("F16_ENSEMBLE_GROWER", raising=False)
    monkeypatch.delenv("F16_XPROF", raising=False)
    monkeypatch.setenv("F16_PERFDB", "0")
    obs.shutdown()
    yield
    obs.shutdown()


@pytest.fixture(scope="module")
def data():
    feats, labels, pids = make_dataset(n_tests=160, n_projects=N_PROJECTS,
                                       seed=5)
    names = [f"project{p:02d}" for p in range(N_PROJECTS)]
    return feats, labels, np.array([names[p] for p in pids]), names, pids


@pytest.fixture(scope="module")
def registry(data, tmp_path_factory):
    reg = ModelRegistry(str(tmp_path_factory.mktemp("regions-registry")),
                        device="cpu")
    reg.fit_and_register(RF, data[0], data[1], max_depth=6,
                         tree_overrides=TINY, seed=3)
    return reg


def _engine(data):
    return SweepEngine(*data, max_depth=8, tree_overrides=TINY,
                       planner_mode=True, device="cpu")


def _ranges(prof):
    """{name: [(start ns, end ns, thread)]} of the capture's ranges."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            s = int(e.start_ns())
            out.setdefault(e.name(), []).append(
                (s, s + int(e.duration_ns()), int(e.start_thread_id())))
    return out


def _inside(child, parents):
    s, t, tid = child
    return any(ps <= s and t <= pt and ptid == tid
               for ps, pt, ptid in parents)


def _serve(svc, model_id, feats, n):
    """n 2-row requests submitted at once; their answers."""
    reqs = [svc.submit(model_id, feats[2 * i:2 * i + 2]) for i in range(n)]
    return [r.result(timeout=60) for r in reqs]


def test_sweep_regions_are_ranges_of_a_capture(data, monkeypatch):
    """A planner run of one RF and one ET config on the hist grower under
    a CPU capture holds every sweep and grower region, each inside its
    parent on the sweep's thread, one BFS step a K1 call; and it gives
    the same scores as the run without a capture."""
    calls = []
    cum_hists = trees.cum_hists

    def counted(*args, **kwargs):
        calls.append(1)
        return cum_hists(*args, **kwargs)

    want = _engine(data).run_grid([RF, ET])
    monkeypatch.setattr(trees, "cum_hists", counted)
    engine = _engine(data)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        got = engine.run_grid([RF, ET])
    finally:
        prof.stop()
    for k in (RF, ET):
        assert got[k][2:] == want[k][2:], k
    ranges = _ranges(prof)
    assert set(SWEEP_REGIONS) <= set(ranges), sorted(ranges)
    for child, parent in PARENT.items():
        for r in ranges[child]:
            assert _inside(r, ranges[parent]), (child, r)
    assert len(ranges["scores.plan"]) == 2
    assert len(ranges["trees.step"]) == len(calls) > 0
    assert len(ranges["trees.k1"]) == len(ranges["trees.sync"]) == len(calls)


class _Ops(TorchDispatchMode):
    """Every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_off_path_reaches_nothing_in_torch(monkeypatch):
    """With neither telemetry nor a capture, a span and a region are the
    shared no-op: no op is dispatched and no ``record_function`` made.
    Under a capture the same block dispatches the ranges' ops."""
    made = []
    real = torch.autograd.profiler.record_function

    def spy(*args, **kwargs):
        made.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    assert not obs.enabled() and not core.capturing()

    def block():
        with _Ops() as mode:
            with obs.span("serve.dispatch", key="m/predict", rows=3) as sp, \
                    obs.region("trees.k1") as rg:
                pass
        return mode.ops, sp, rg

    ops, sp, rg = block()
    assert ops == [] and made == []
    assert sp is core._NULL_SPAN and rg is core._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert core.capturing()
        ops, sp, rg = block()
    assert not core.capturing()
    assert [a[0] for a in made] == ["serve.dispatch", "trees.k1"]
    assert any("record_function" in op for op in ops), ops


def test_spans_share_the_capture_clock(data, registry, tmp_path):
    """Telemetry and a capture both on: each ``scores.plan`` range (the
    capture's, on this thread) and each ``serve.dispatch`` (the port's
    log, on the dispatcher threads the capture does not record) lies
    inside its JSONL span's [ts - wall_s, ts] within 1 ms; regions write
    no JSONL event."""
    run_dir = obs.configure(root=str(tmp_path), heartbeat_s=0)
    engine = _engine(data)
    svc = ScoringService(registry, buckets=(4, 16), device="cpu").start()
    try:
        n_log = len(obs.thread_regions())
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            engine.run_grid([RF])
            _serve(svc, registry.ids()[0], data[0], 12)
        log = obs.thread_regions()[n_log:]
    finally:
        svc.stop()
        obs.shutdown()
    with open(os.path.join(run_dir, "events.jsonl")) as fd:
        events = [json.loads(line) for line in fd]
    spans = {}
    for ev in events:
        if ev["kind"] == "span":
            spans.setdefault(ev["name"], []).append(
                (ev["ts"] - ev["wall_s"], ev["ts"]))
    assert not set(SWEEP_REGIONS) & set(spans)
    got = {"scores.plan": [(s, t) for s, t, _ in _ranges(prof)["scores.plan"]],
           "serve.dispatch": [(s, t) for name, s, t, _ in log
                              if name == "serve.dispatch"]}
    for name, ranges in got.items():
        assert len(ranges) == len(spans[name]) > 0, name
        for s, t in ranges:
            assert any(lo - 1e-3 <= s / 1e9 and t / 1e9 <= hi + 1e-3
                       for lo, hi in spans[name]), (name, s, t)


def test_service_counts_waits_without_gauges(data, registry, monkeypatch):
    """Telemetry off: 64 requests are counted once each with finite queue
    and handoff waits, and no dispatch sorts the latency ring or takes
    the queue's lock for a gauge."""
    svc = ScoringService(registry, buckets=(4, 16), device="cpu").start()
    snaps, depths = [], []
    snapshot, depth = svc.latency.snapshot, svc.requests.depth
    monkeypatch.setattr(svc.latency, "snapshot",
                        lambda: snaps.append(1) or snapshot())
    monkeypatch.setattr(svc.requests, "depth",
                        lambda: depths.append(1) or depth())
    try:
        answers = _serve(svc, registry.ids()[0], data[0], 64)
        waits = svc.batcher.wait_stats()
        assert snaps == [] and depths == []
        stats = svc.stats()
    finally:
        svc.stop()
    assert len(answers) == 64
    assert svc.batcher.answered == stats["requests"] == 64
    for key in ("queue_wait_ms", "handoff_wait_ms"):
        assert math.isfinite(stats[key]) and stats[key] >= 0, key
        assert waits[key] == stats[key], key
    assert stats["queue_wait_ms"] > 0


def test_counting_pass_is_the_same_under_a_capture():
    """The grower's counted flops and bytes do not see the ranges'
    ops."""
    feats, labels, _ = make_dataset(n_tests=96, n_projects=2, seed=9)
    x = torch.as_tensor(feats, dtype=torch.float32)
    y = torch.as_tensor(labels == 2)
    w = torch.ones(x.shape[0])
    key = rng.prng_key(4, "cpu")

    def counted():
        with costs.counting_pass() as p:
            trees.fit_forest_hist(x, y, w, key, n_trees=3, bootstrap=True,
                                  random_splits=False, sqrt_features=True,
                                  max_depth=6)
        return p.flops, p.bytes

    off = counted()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = counted()
    assert "trees.k1" in _ranges(prof)
    assert on == off and off[1] > 0


def test_o103_covers_region_names(tmp_path):
    path = tmp_path / "regions.py"
    path.write_text(
        "from flake16_framework_tpu_torch import obs\n\n\n"
        "def stage():\n"
        "    with obs.region(\"trees.k1\"):\n"
        "        pass\n"
        "    with obs.region(\"Trees K1\"):\n"
        "        pass\n")
    found = [(f.rule, f.line) for f in
             Engine((rules_obs,)).lint([str(path)]).findings]
    assert found == [("O103", 7)]


@pytest.mark.parametrize("all_threads", [False, True])
def test_thread_regions_log_only_unrecorded_threads(all_threads):
    """Under a capture started on this thread, a region on another
    thread is logged with its times on the capture's clock; one on this
    thread is a range and is not logged. A ``profile_all_threads``
    capture records every thread but tells none that it does: both are
    logged, and neither is a range."""
    from torch._C._profiler import _ExperimentalConfig

    n = len(obs.thread_regions())

    def other():
        with obs.region("serve.collect"):
            pass

    config = _ExperimentalConfig(profile_all_threads=all_threads)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=config) as prof:
        with obs.region("serve.pad"):
            pass
        t = threading.Thread(target=other)
        t.start()
        t.join()
    log = {e[0]: e[1:] for e in obs.thread_regions()[n:]}
    ranges = _ranges(prof)
    ls, lt, tid = log.pop("serve.collect")
    assert tid == t.ident and ls <= lt and "serve.collect" not in ranges
    if all_threads:
        assert list(log) == ["serve.pad"] and "serve.pad" not in ranges
    else:
        (s, _, _), = ranges["serve.pad"]
        assert log == {} and s <= ls
