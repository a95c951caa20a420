"""The end-to-end metrics are taken over the whole window: a rate over
all the work and all the time, a percentile over every request. A stall
or a slow stretch inside the window moves them."""

import time
import types

import numpy as np

from port_bench.harness import stats
from port_bench.harness.tracer import Tracer
from port_bench.traffic import serve_closed, sweep


def test_rate_and_percentile_take_every_sample():
    assert stats.rate(10, 0.0, 5.0) == 2.0
    assert stats.rate(0, 0.0, 5.0) is None
    assert stats.percentile(list(range(101)), 95) == 95.0
    assert stats.percentile([1.0, 2.0], 50) == 1.5
    assert stats.percentile([], 95) is None


class _Req:
    def __init__(self, at, out):
        self._at, self._out = at, out

    def done(self):
        return time.perf_counter() >= self._at

    def result(self, timeout=None):
        time.sleep(max(0.0, self._at - time.perf_counter()))
        return self._out


class _Service:
    """Answers each request 2 ms after it is sent, or 10 ms after while
    the host is slow (``slow``: seconds from the first request); refuses
    the requests whose count is in ``refuse``."""

    def __init__(self, slow=None, refuse=()):
        self.slow, self.refuse = slow, set(refuse)
        self.t0 = None
        self.sent = 0

    def submit(self, model_id, x, kind="predict"):
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
        self.sent += 1
        if self.sent in self.refuse:
            raise RuntimeError("queue full")
        wait = 0.002
        if self.slow is not None and \
                self.slow[0] <= now - self.t0 < self.slow[1]:
            wait = 0.010
        return _Req(now + wait, np.zeros((len(x), 2), np.float32))


def _serve_state(service):
    run = types.SimpleNamespace(
        seed=3, params={"clients": 4, "rows": 4, "kinds": ["predict"],
                        "check": {"requests": 8}})
    study = types.SimpleNamespace(features=np.zeros((100, 16)))
    return {"run": run, "study": study, "service": service,
            "model_ids": ["a", "b"]}


def test_serve_window_counts_every_request_and_a_slow_stretch():
    calm = serve_closed.window(_serve_state(_Service()), 1.0, Tracer(False))
    slow = serve_closed.window(_serve_state(_Service(slow=(0.3, 0.6))),
                               1.0, Tracer(False))
    for rec in (calm, slow):
        assert rec["failed"] == 0
        assert rec["attempted"] == rec["extra"]["answered"] == \
            len(rec["answers"])
        assert rec["serve_rps"] == rec["attempted"] / rec["extra"]["window_s"]
    # Three tenths of the window at five times the latency: about 8% of
    # the requests take 10 ms, so the 95th percentile of all of them
    # sees it, and the rate falls by about a quarter.
    assert slow["serve_p95_ms"] > calm["serve_p95_ms"] + 5.0
    assert slow["serve_rps"] < 0.85 * calm["serve_rps"]
    assert len(serve_closed.sample(_serve_state(None), calm)) == 8


def test_serve_rate_is_taken_to_the_last_answer():
    class Late(_Service):
        def submit(self, model_id, x, kind="predict"):
            req = super().submit(model_id, x, kind)
            if time.perf_counter() - self.t0 > 0.45:
                req._at += 0.5          # the last answers come late
            return req

    calm = serve_closed.window(_serve_state(_Service()), 0.5, Tracer(False))
    late = serve_closed.window(_serve_state(Late()), 0.5, Tracer(False))
    assert late["extra"]["window_s"] > 0.9
    assert late["serve_rps"] < 0.7 * calm["serve_rps"]


def test_a_refused_request_counts_as_failed():
    rec = serve_closed.window(_serve_state(_Service(refuse={5, 9})), 0.3,
                              Tracer(False))
    assert rec["failed"] == 2
    assert rec["attempted"] == rec["extra"]["answered"] + 2
    assert len(rec["extra"]["errors"]) == 2


class _Engine:
    def __init__(self, stall_at=None):
        self.calls = 0
        self.stall_at = stall_at

    def run_grid(self, configs):
        self.calls += 1
        time.sleep(0.3 if self.calls == self.stall_at else 0.02)
        return {tuple(configs[0]): [0.0, 0.0, {}, [0, 0, 0]]}


def _sweep_state(engine):
    run = types.SimpleNamespace(seed=1, params={"trace": {"from": 99}})
    return {"run": run, "engine": engine,
            "configs": sweep.config_list({
                "flaky": ["NOD"], "features": ["Flake16"],
                "prep": ["Scaling"], "balancing": ["None", "SMOTE"],
                "model": ["Random Forest"]})}


def test_sweep_rate_covers_the_config_in_flight_and_a_stall():
    calm = sweep.window(_sweep_state(_Engine()), 0.5, Tracer(False))
    stalled = sweep.window(_sweep_state(_Engine(stall_at=3)), 0.5,
                           Tracer(False))
    # The config in flight at the deadline completes and counts.
    assert calm["window_s"] >= 0.5
    assert calm["configs_per_s"] == len(calm["done"]) / calm["window_s"]
    assert stalled["configs_per_s"] < 0.8 * calm["configs_per_s"]
