"""The dispatch guard: the wrapper every ``scores`` config runs under (a
copy of the JAX package's, for CUDA). A guarded call:

1. consults the injection plan (``F16_FAULT_INJECT``, inject.py) so every
   path below runs deterministically on the CPU;
2. runs the thunk, then synchronises its CUDA device (every card of a
   device list, for a config batch split across cards): a CUDA error
   surfaces at the next synchronisation, not at the launch that caused it,
   and it must land inside the guard of the config that caused it, not in
   the next one. An optional watchdog deadline (``F16_FAULT_ENVELOPE_S``,
   default 0 = off) runs the thunk in a worker thread and gives up on it
   when it overruns;
3. classifies any failure (faults.py) and either
   - retries with exponential backoff + jitter (bounded attempts); an
     ``oom`` retry first empties PyTorch's CUDA cache, or
   - raises ``DispatchAbandoned`` (deterministic class, or retries
     exhausted) carrying the fault class + full attempt history — the
     record the sweep's quarantine sidecar keeps.

Guarded thunks must be deterministic (the sweep's configs are: explicit
key tables), so a retry is bit-identical. A CUDA error that kills the
context is ``deterministic``: it is not retried in the process it killed.
An overrun is not retried in the process either, though its class is
retryable: a launched kernel cannot be cancelled, so the overrun's worker
goes on running on the same device (and, in the sweep, the same journal).
While it runs, every later call is abandoned at once, without running, as
``envelope-overrun``; the sweep quarantines those configs and a ``resume``
in a fresh process reruns them. Once the worker has ended, calls run again.

Backoff sleeps go through ``time.sleep`` looked up AT CALL TIME (tests
monkeypatch the module attribute), or an injected ``sleep`` callable.
Each retry is appended to ``retries`` (label, attempt, class, error,
backoff), the record of the faults the guard recovered from. Each
transition is also a ``fault`` event (``retry``, ``recovered``,
``abandon``) with the JAX package's fields; the port has no degradation
ladder, so no ``degrade`` event.
"""

import os
import random
import sys
import threading
import time

from flake16_framework_tpu_torch import obs
from flake16_framework_tpu_torch.resilience import faults, inject


class DispatchAbandoned(RuntimeError):
    """A guarded dispatch gave up: non-retryable class, or retries
    exhausted. ``fault_class``/``attempts``/``original`` carry the
    quarantine record; the attribute also makes an OUTER guard classify
    this exception as the inner fault class."""

    def __init__(self, label, fault_class, attempts, original):
        super().__init__(
            f"dispatch {label or '?'} abandoned after {len(attempts)} "
            f"attempt(s) [{fault_class}]: {original}")
        self.label = label
        self.fault_class = fault_class
        self.attempts = list(attempts)
        self.original = original


class BackoffPolicy:
    """Exponential backoff with multiplicative jitter; ``max_attempts``
    bounds total tries (1 = no retry)."""

    def __init__(self, max_attempts=3, base_s=5.0, factor=2.0, max_s=60.0,
                 jitter=0.5):
        self.max_attempts = max(1, int(max_attempts))
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.max_s = float(max_s)
        self.jitter = float(jitter)

    def delay_s(self, failed_attempt, rng):
        """Backoff after the ``failed_attempt``-th (1-based) failure."""
        d = min(self.max_s, self.base_s * self.factor ** (failed_attempt - 1))
        if self.jitter and d > 0:
            d *= 1.0 + self.jitter * rng.random()
        return d


def policy_from_env(environ=None):
    env = environ if environ is not None else os.environ
    return BackoffPolicy(
        max_attempts=int(env.get("F16_FAULT_MAX_ATTEMPTS", "3") or 3),
        base_s=float(env.get("F16_FAULT_BACKOFF_S", "5") or 0.0),
        max_s=float(env.get("F16_FAULT_BACKOFF_MAX_S", "60") or 60.0),
    )


def _cuda(device):
    """torch, when ``device`` is a CUDA device and torch is loaded."""
    torch = sys.modules.get("torch")
    if torch is None or device is None:
        return None
    return torch if torch.device(device).type == "cuda" else None


class DispatchGuard:
    """See module docstring. ``sleep``/``rng`` are injectable so tests
    exercise the backoff schedule without real sleeps; ``device`` is the
    torch device the thunk drives, or a list of them: each CUDA device is
    synchronised inside the guard."""

    def __init__(self, policy=None, plan=None, *, sleep=None, rng=None,
                 envelope_s=None, device=None):
        self.policy = policy or BackoffPolicy()
        self.plan = plan
        # Default sleeper resolves time.sleep per call (monkeypatchable).
        self._sleep = sleep if sleep is not None else (
            lambda s: time.sleep(s))
        self._rng = rng if rng is not None else random.Random(0xF16)
        if envelope_s is None:
            envelope_s = float(os.environ.get("F16_FAULT_ENVELOPE_S", "0")
                               or 0.0)
        self.envelope_s = envelope_s
        self.device = device
        self.retries = []
        self._orphan = None  # the worker of the last overrun

    def call(self, thunk, *, config_index=None, label=None):
        """Run ``thunk`` under the guard; returns its result or raises
        DispatchAbandoned with the attempt history."""
        attempts = []
        lbl = {"config": label} if label else {}
        n = self.policy.max_attempts
        for attempt in range(1, n + 1):
            try:
                if self._orphan_running():
                    raise faults.EnvelopeOverrun(
                        "an earlier dispatch that overran the watchdog "
                        "envelope is still running")
                if self.plan is not None:
                    self.plan.check(config_index, attempt)
                out = self._dispatch(thunk)
                if attempts:
                    obs.event("fault",
                              fault_class=attempts[-1]["fault_class"],
                              action="recovered", attempt=attempt, **lbl)
                return out
            except Exception as e:
                fc = faults.classify(e)
                rec = {"attempt": attempt, "fault_class": fc,
                       "error": str(e)[:200]}
                attempts.append(rec)
                if fc not in faults.RETRYABLE or attempt >= n or \
                        self._orphan_running():
                    obs.event("fault", fault_class=fc, action="abandon",
                              attempt=attempt, error=rec["error"], **lbl)
                    raise DispatchAbandoned(label, fc, attempts, e) from e
                if fc == faults.OOM:
                    torch = _cuda(self._devices()[0])
                    if torch is not None:
                        torch.cuda.empty_cache()
                delay = self.policy.delay_s(attempt, self._rng)
                rec["backoff_s"] = round(delay, 3)
                self.retries.append(dict(rec, label=label))
                obs.event("fault", fault_class=fc, action="retry",
                          attempt=attempt, backoff_s=rec["backoff_s"],
                          error=rec["error"], **lbl)
                if delay > 0:
                    self._sleep(delay)

    # -- internals ------------------------------------------------------

    def _orphan_running(self):
        return self._orphan is not None and self._orphan.is_alive()

    def _devices(self):
        return self.device if isinstance(self.device, (list, tuple)) \
            else [self.device]

    def _finish(self, out):
        for device in self._devices():
            torch = _cuda(device)
            if torch is not None:
                # One synchronize a card of the call, each its own.
                torch.cuda.synchronize(device)  # f16lint: disable=J402
        return out

    def _dispatch(self, thunk):
        if not self.envelope_s or self.envelope_s <= 0:
            return self._finish(thunk())
        # Watchdog: run + synchronise in a daemon worker so the deadline
        # can fire while the device works. An overrun orphans the worker
        # (a launched kernel cannot be cancelled); ``call`` runs nothing
        # while it lives.
        box = {}
        device = self._devices()[0]
        torch = _cuda(device)
        if torch is not None:
            # A new thread starts on the current device, not on the
            # caller's: the worker sets it by index (plain "cuda" is the
            # caller's current device).
            index = torch.device(device).index
            if index is None:
                index = torch.cuda.current_device()

        def work():
            try:
                if torch is not None:
                    torch.cuda.set_device(index)
                box["out"] = self._finish(thunk())
            # The guard is the resilience layer: the exception crosses to
            # the caller's thread, where the guard classifies it.
            except BaseException as e:  # f16lint: disable=J501
                box["exc"] = e

        t = threading.Thread(target=work, daemon=True,
                             name="f16-dispatch-guard")
        t.start()
        t.join(self.envelope_s)
        if t.is_alive():
            self._orphan = t
            raise faults.EnvelopeOverrun(
                f"dispatch exceeded the {self.envelope_s:g}s watchdog "
                f"envelope (F16_FAULT_ENVELOPE_S)")
        if "exc" in box:
            raise box["exc"]
        return box["out"]


def default_guard(plan=None, **kw):
    """The env-configured guard (F16_FAULT_MAX_ATTEMPTS /
    F16_FAULT_BACKOFF_S / F16_FAULT_BACKOFF_MAX_S / F16_FAULT_ENVELOPE_S /
    F16_FAULT_INJECT)."""
    if plan is None:
        plan = inject.plan_from_env()
    return DispatchGuard(policy=policy_from_env(), plan=plan, **kw)
