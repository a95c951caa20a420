"""SLO monitor: multi-window burn-rate evaluation that sheds load (the
JAX package's ``obs/slo.py``, with the same burn-rate arithmetic and the
same ``summary()`` keys).

The serving stack declares objectives (p99 latency, error rate); the
monitor folds every completed request into two sliding windows (fast +
slow: the fast window reacts, the slow window keeps one latency spike
from flapping the fleet) and on each evaluation compares the measured
burn — the rate at which the error/latency budget is being spent, 1.0 =
exactly on budget — against trip thresholds.

Transitions do two things, in order:

- **actuate**: entering breach starts SHEDDING (``serve``'s admission
  path rejects new submits with a retriable rejection while
  ``monitor.shedding``); recovery clears it. That is the whole actuation:
  the JAX package also steps its pallas→xla ladder on a breach, and this
  package has no such ladder — the SHAP kernel stays the SHAP kernel, on
  the device it was given.
- **witness**: every transition emits an ``slo`` event with both burns
  (``degraded`` is always False).
"""

import threading
import time

from flake16_framework_tpu_torch.obs import core


class SLOConfig:
    """Declared objectives + evaluation windows for one serving process.

    ``latency_budget``/``error_budget`` are the tolerated fractions of
    requests over-objective / failed; burn = measured fraction divided
    by budget (1.0 = spending exactly on budget). A breach requires BOTH
    windows >= ``shed_burn``; recovery requires the fast window back
    under ``clear_burn``. ``min_events`` keeps an idle or cold window
    from evaluating on noise. ``degrade`` and ``kernel`` are kept so that
    ``describe()`` has the JAX package's keys; they actuate nothing in
    this package (it has no fallback to degrade to)."""

    __slots__ = ("p99_ms", "latency_budget", "error_budget",
                 "fast_window_s", "slow_window_s", "shed_burn",
                 "clear_burn", "min_events", "degrade", "kernel")

    def __init__(self, p99_ms=50.0, latency_budget=0.05, error_budget=0.02,
                 fast_window_s=5.0, slow_window_s=30.0, shed_burn=2.0,
                 clear_burn=1.0, min_events=8, degrade=True,
                 kernel="shap"):
        self.p99_ms = float(p99_ms)
        self.latency_budget = float(latency_budget)
        self.error_budget = float(error_budget)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.shed_burn = float(shed_burn)
        self.clear_burn = float(clear_burn)
        self.min_events = int(min_events)
        self.degrade = bool(degrade)
        self.kernel = kernel

    def describe(self):
        return {name: getattr(self, name) for name in self.__slots__}


class SLOMonitor:
    """Feed with ``observe``; poll with ``evaluate`` (the batcher calls
    it once per dispatched batch). ``shedding`` is the admission path's
    single-read gate."""

    def __init__(self, config=None):
        self.config = config or SLOConfig()
        self._lock = threading.Lock()
        self._samples = []  # (ts, latency_ms or None, error) oldest-first
        self.shedding = False
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.worst_burn_fast = 0.0
        self.worst_burn_slow = 0.0
        self.breaches = 0
        self.recoveries = 0
        self.shed_total = 0
        self.observed_total = 0
        # Cumulative (never-pruned) budget accounting: two snapshots
        # bracket an interval's error-budget spend exactly (the rolling
        # restart's annotation).
        self.total_errors = 0
        self.total_over_latency = 0
        self.time_in_degraded_s = 0.0
        self._degraded_since = None

    # -- feed ------------------------------------------------------------

    def observe(self, latency_ms=None, error=False, now=None):
        """One completed (or failed) request."""
        now = time.time() if now is None else now
        with self._lock:
            self._samples.append((now, latency_ms, bool(error)))
            self.observed_total += 1
            if error:
                self.total_errors += 1
            elif latency_ms is not None and latency_ms > self.config.p99_ms:
                self.total_over_latency += 1
            self._prune(now)

    def record_shed(self):
        """One admission rejected because of the shedding state."""
        with self._lock:
            self.shed_total += 1
        core.counter_add("serve.shed")

    def _prune(self, now):
        horizon = now - self.config.slow_window_s
        drop = 0
        for ts, _, _ in self._samples:
            if ts >= horizon:
                break
            drop += 1
        if drop:
            del self._samples[:drop]

    # -- evaluate + actuate ----------------------------------------------

    def _window_burn(self, samples):
        cfg = self.config
        n = len(samples)
        if n < cfg.min_events:
            return 0.0
        over = sum(1 for _, lat, _ in samples
                   if lat is not None and lat > cfg.p99_ms)
        errors = sum(1 for _, _, err in samples if err)
        return max((over / n) / cfg.latency_budget,
                   (errors / n) / cfg.error_budget)

    def evaluate(self, now=None):
        """Recompute both burns and run the transition machine. Returns
        the current state dict (what the slo events carry)."""
        cfg = self.config
        now = time.time() if now is None else now
        with self._lock:
            self._prune(now)
            slow = list(self._samples)
            fast_horizon = now - cfg.fast_window_s
            fast = [s for s in slow if s[0] >= fast_horizon]
            self.burn_fast = self._window_burn(fast)
            self.burn_slow = self._window_burn(slow)
            self.worst_burn_fast = max(self.worst_burn_fast,
                                       self.burn_fast)
            self.worst_burn_slow = max(self.worst_burn_slow,
                                       self.burn_slow)
            lats = sorted(lat for _, lat, _ in fast if lat is not None)
            p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))] \
                if lats else 0.0
            err_rate = (sum(1 for _, _, e in fast if e) / len(fast)) \
                if fast else 0.0
            breach = (not self.shedding
                      and self.burn_fast >= cfg.shed_burn
                      and self.burn_slow >= cfg.shed_burn)
            recover = self.shedding and self.burn_fast < cfg.clear_burn
            if breach:
                self.shedding = True
                self.breaches += 1
                self._degraded_since = now
            elif recover:
                self.shedding = False
                self.recoveries += 1
                if self._degraded_since is not None:
                    self.time_in_degraded_s += now - self._degraded_since
                    self._degraded_since = None
            state = {"burn_fast": round(self.burn_fast, 3),
                     "burn_slow": round(self.burn_slow, 3),
                     "p99_ms": round(float(p99), 3),
                     "error_rate": round(err_rate, 4),
                     "shed_total": self.shed_total,
                     "shedding": self.shedding}
        # The witness outside the lock: the sink takes its own, and
        # observe() must never wait on it.
        if breach:
            core.event("slo", state="breach", degraded=False, **state)
        elif recover:
            core.event("slo", state="recovered", **state)
        return state

    # -- reporting -------------------------------------------------------

    def budget_snapshot(self):
        """Cumulative event/error/over-latency totals. Two snapshots
        bracket an interval; :func:`budget_spend` turns the deltas into
        that interval's burn."""
        with self._lock:
            return {"events": self.observed_total,
                    "errors": self.total_errors,
                    "over_latency": self.total_over_latency}

    def summary(self, now=None):
        """The rollup ``serve --json`` reports."""
        now = time.time() if now is None else now
        with self._lock:
            degraded_s = self.time_in_degraded_s
            if self._degraded_since is not None:
                degraded_s += now - self._degraded_since
            total = self.observed_total + self.shed_total
            return {
                "worst_burn_fast": round(self.worst_burn_fast, 3),
                "worst_burn_slow": round(self.worst_burn_slow, 3),
                "breaches": self.breaches,
                "recoveries": self.recoveries,
                "shed_total": self.shed_total,
                "serve_shed_pct": round(100.0 * self.shed_total / total, 3)
                if total else 0.0,
                "time_in_degraded_s": round(degraded_s, 3),
                "shedding": self.shedding,
                "objective_p99_ms": self.config.p99_ms,
            }


def budget_spend(before, after, config):
    """The error-budget spend of the interval two
    :meth:`SLOMonitor.budget_snapshot` calls bracket: the event/error/
    over-latency deltas plus ``burn`` — the interval's measured burn
    rate under ``config``'s budgets (the max-of-fractions math of
    :meth:`SLOMonitor._window_burn` over an exact interval). Zero events
    = zero burn."""
    events = int(after["events"]) - int(before["events"])
    errors = int(after["errors"]) - int(before["errors"])
    over = int(after["over_latency"]) - int(before["over_latency"])
    burn = 0.0
    if events > 0:
        burn = max((over / events) / config.latency_budget,
                   (errors / events) / config.error_budget)
    return {"events": events, "errors": errors, "over_latency": over,
            "burn": round(burn, 3)}
