"""The metrics that read the program's own spans, on hand-built traces:
device time under the grower's stages, BFS steps, idle under the sweep's
prep and resample and under the service's dispatches and their legs
(ranges from the trace and from the port's log of its unrecorded
threads), the service's wait counters; and nothing where the program
opens no such span. Then one traced tiny run of a study cell and of a
serving cell on the CPU."""

import math

import pytest

from port_bench.harness import program, spec
from port_bench.harness import timeline as tl
from port_bench.harness.timeline import Ev
from port_bench.tests import tiny


def _k(name, s, e, corr):
    return Ev("kernel", name, s, e, -1, corr)


def _rt(s, e, corr, tid=1):
    return Ev("runtime", "cudaLaunchKernel", s, e, tid, corr)


def _range(name, s, e, tid=1):
    return Ev("range", name, s, e, tid, 0)


class _Tracer:
    def __init__(self, events, **units):
        self.events = events
        self.units = units
        self.calls = {}


def _metric(name):
    return spec.load_module("metrics", name, spec.BENCH_DIR)


def _ctx(events, t0, t1, **units):
    return {"tracer": _Tracer(events, **units), "t0": t0, "t1": t1}


@pytest.fixture(autouse=True)
def no_thread_log(monkeypatch):
    monkeypatch.setattr(program, "_thread_log", lambda: [])


# A traced stretch of 2 configs: a fit whose draws, K1, split scan and
# routing each launch kernels, two BFS steps, a third step outside the
# window, and prep and resample ranges with idle gaps inside them.
GROWER = [
    _range(tl.WINDOW_RANGE, 0, 1000),
    _range("trees.draws", 10, 20), _rt(11, 12, 1), _rt(13, 14, 2),
    _range("trees.step", 30, 60), _range("trees.k1", 31, 35), _rt(32, 33, 3),
    _range("trees.split", 36, 45), _rt(37, 38, 4),
    _range("trees.route", 46, 55), _rt(47, 48, 5), _rt(49, 50, 6),
    _range("trees.step", 60, 90), _range("trees.split", 61, 70),
    _rt(62, 63, 7),
    _range("trees.step", 1100, 1200),
    _k("threefry", 100, 300, 1), _k("bootstrap", 300, 340, 2),
    _k("cum_hists", 340, 360, 3), _k("scan", 360, 400, 4),
    _k("route", 400, 410, 5), _k("route", 410, 430, 6),
    _k("scan", 430, 460, 7),
    _range("sweep.prep", 460, 520), _k("edges", 480, 500, 8),
    _range("sweep.resample", 510, 600), _k("knn", 560, 600, 9),
]


@pytest.mark.parametrize("name, want", [
    ("grower.draws.device_ms_per_config", (200 + 40) / 2 / 1e6),
    ("grower.split.device_ms_per_config", (40 + 30) / 2 / 1e6),
    ("grower.route.device_ms_per_config", (10 + 20) / 2 / 1e6),
    ("grower.k1.device_ms_per_config", 20 / 2 / 1e6),
    ("grower.steps_per_config", 2 / 2),
    # idle inside prep or resample: 460-480, 500-560
    ("prep.idle_ms_per_config", (20 + 60) / 2 / 1e6),
])
def test_study_metrics_read_the_program_ranges(name, want):
    got = _metric(name).read(_ctx(GROWER, 0, 1000, configs=2))
    assert math.isclose(got, want, rel_tol=1e-12)


@pytest.mark.parametrize("name", [
    "grower.draws.device_ms_per_config", "grower.split.device_ms_per_config",
    "grower.route.device_ms_per_config", "grower.k1.device_ms_per_config",
    "grower.steps_per_config", "prep.idle_ms_per_config"])
def test_study_metrics_give_nothing_without_the_program_ranges(name):
    plain = [e for e in GROWER if e.kind != "range"
             or e.name == tl.WINDOW_RANGE]
    assert _metric(name).read(_ctx(plain, 0, 1000, configs=2)) is None
    assert _metric(name).read(_ctx(GROWER, 0, 1000)) is None   # no configs


def test_dispatch_idle_reads_the_unrecorded_threads_log(monkeypatch):
    """Dispatches on the service's threads are in the port's log, not the
    trace; idle is counted once where two dispatches overlap, and only
    inside the window."""
    evs = [_range(tl.WINDOW_RANGE, 0, 1000),
           _k("replay", 100, 150, 1), _k("replay", 400, 420, 2)]
    log = [("serve.dispatch", 80, 200, 11), ("serve.dispatch", 120, 260, 12),
           ("serve.collect", 0, 1000, 13),
           ("serve.dispatch", 950, 1100, 11),     # runs past the window
           ("serve.dispatch", 1200, 1300, 12)]    # outside the window
    monkeypatch.setattr(program, "_thread_log", lambda: log)
    got = _metric("serve.idle_in_dispatch_pct").read(_ctx(evs, 0, 1000))
    # idle in 80-100, 150-260 and 950-1000
    assert math.isclose(got, 100.0 * (20 + 110 + 50) / 1000)
    monkeypatch.setattr(program, "_thread_log", lambda: [])
    assert _metric("serve.idle_in_dispatch_pct").read(
        _ctx(evs, 0, 1000)) is None


# Each leg of the serving path, its metric: idle while the leg is open.
LEGS = [("serve.collect", "serve.idle_in_collect_pct"),
        ("serve.handoff", "serve.idle_in_handoff_pct"),
        ("serve.pad", "serve.idle_in_pad_pct"),
        ("store.copy_in", "store.idle_in_copy_in_pct"),
        ("store.replay", "store.idle_in_replay_pct"),
        ("store.clone", "store.idle_in_clone_pct"),
        ("serve.copy_out", "serve.idle_in_copy_out_pct"),
        ("serve.complete", "serve.idle_in_complete_pct")]


@pytest.mark.parametrize("leg, name", LEGS)
def test_leg_idle_reads_its_own_range(monkeypatch, leg, name):
    """Leg i of the log is open over [100 i, 100 i + 80) on its own
    thread, the device busy over [100 i + 40, 100 i + 60) of it: each
    metric counts the 60 idle ns of its own leg and no other's; the
    same leg on a second thread over an overlapping stretch counts its
    idle once."""
    evs = [_range(tl.WINDOW_RANGE, 0, 1000)]
    log = []
    for i, (other, _) in enumerate(LEGS):
        evs.append(_k("op", 100 * i + 40, 100 * i + 60, i))
        log.append((other, 100 * i, 100 * i + 80, 20 + i))
        if other == leg:
            log.append((other, 100 * i + 10, 100 * i + 70, 40 + i))
    monkeypatch.setattr(program, "_thread_log", lambda: log)
    got = _metric(name).read(_ctx(evs, 0, 1000))
    assert math.isclose(got, 100.0 * 60 / 1000)
    monkeypatch.setattr(program, "_thread_log",
                        lambda: [e for e in log if e[0] != leg])
    assert _metric(name).read(_ctx(evs, 0, 1000)) is None


def test_ranges_merge_the_trace_and_the_log(monkeypatch):
    evs = [_range("sweep.prep", 10, 20), _range("other", 0, 5)]
    monkeypatch.setattr(program, "_thread_log",
                        lambda: [("sweep.prep", 30, 40, 2)])
    assert program.ranges(evs, ("sweep.prep",)) == [(10, 20), (30, 40)]
    assert program.ranges(evs, ("sweep.prep",), 25, 100) == [(30, 40)]
    assert program.union([(0, 5), (3, 9), (12, 14)]) == [(0, 9), (12, 14)]
    assert program.overlap_ns([(0, 9), (12, 14)], [(5, 13)]) == 4 + 1


class _Service:
    def __init__(self, stats):
        self._stats = stats

    def stats(self):
        return dict(self._stats)


@pytest.mark.parametrize("name, key", [
    ("serve.queue_wait_ms", "queue_wait_ms"),
    ("serve.handoff_wait_ms", "handoff_wait_ms")])
def test_serving_waits_read_the_services_counters(name, key):
    reader = _metric(name)
    got = reader.read({"state": {"service": _Service({key: 3.25})}})
    assert got == 3.25
    # a service that keeps no such count, or has answered nothing
    assert reader.read({"state": {"service": _Service({})}}) is None
    assert reader.read({"state": {"service": _Service({key: None})}}) \
        is None


@pytest.mark.parametrize("cell, names", [
    ("study-scores-hist", ("grower.steps_per_config",)),
    ("serve-ci-predict", ("serve.queue_wait_ms", "serve.handoff_wait_ms",
                          "serve.idle_in_dispatch_pct",
                          "serve.idle_in_collect_pct",
                          "serve.idle_in_handoff_pct",
                          "serve.idle_in_pad_pct",
                          "serve.idle_in_copy_out_pct",
                          "serve.idle_in_complete_pct"))])
def test_a_traced_tiny_run_reports_the_program_counters(tmp_path, cell,
                                                         names, monkeypatch):
    """On the CPU the trace holds no device event, so the device-time
    metrics are left out; the program's counters are read, and the
    serving threads' ranges reach the idle shares (all idle here) through
    the port's log. (The store's legs run only on a CUDA graph.)"""
    monkeypatch.undo()              # the port's own log
    root = tiny.make_root(tmp_path)
    out = tiny.execute(root, cell, trace=1)
    assert out["correct"], out["checks"]
    for name in names:
        value = out["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
