"""ScoringService: the in-process client API over registry + store +
queue + microbatcher, with p50/p99 latency.

``start()`` prepares every registered model and runs one zero batch of
each kind at every bucket shape (the warm bill is paid at service start,
never during a request), then starts the batcher threads. ``submit``
returns the request future; ``score`` is the synchronous wrapper.

``drain()`` is the preemption path: admission closes, in-flight
microbatches complete, queued-but-unstarted requests fail with
:class:`~flake16_framework_tpu_torch.serve.queue.RetriableRejection`
(resubmit is safe — nothing was dispatched), and every durable serve
artifact flushes (registry index, warm manifest). Past the deadline the
drain escalates to checkpoint-and-abort: the flush still runs, handed-off
batches fail with a plain ServeError. Zero requests are ever silently
dropped — each submitted future either completes or raises.

With ``slo`` (an ``obs.slo.SLOConfig``, or True for the defaults) an
SLO monitor watches the served latencies and errors; while its burn rate
stands in breach, admission sheds load with a retriable rejection. That
is all a breach does: the SHAP kernel and the device stay as they are.
The warm span, the drain events and the manifest facts go to the
telemetry (no-ops unless it is on).

Without ``buckets`` the service consults the performance database for a
recorded warm-bucket ladder (``resolve_buckets``) and falls through to
DEFAULT_BUCKETS bit-identically when none is usable. With
``metrics_port`` (0 = ephemeral) a Prometheus exporter stands beside the
service from ``start`` to ``stop`` (``obs/metrics.py``).
"""

import os
import threading
import time

import numpy as np

from flake16_framework_tpu_torch import obs
from flake16_framework_tpu_torch.obs.slo import SLOConfig, SLOMonitor
from flake16_framework_tpu_torch.serve.batcher import Microbatcher
from flake16_framework_tpu_torch.serve.queue import (
    RequestQueue, RequestRejected, RetriableRejection, ScoreRequest,
    ServeError,
)
from flake16_framework_tpu_torch.serve.store import (
    ExecutableStore, KINDS, MANIFEST_FILE,
)

# The bucket ladder every serve entry point warms when nothing better is
# known — the fall-through side of the perfdb consult below.
DEFAULT_BUCKETS = (8, 32, 128)


def resolve_buckets(buckets=None, backend=None):
    """The warm-bucket ladder for a service: an explicit ``buckets``
    wins untouched; ``None`` consults the performance database
    (obs/perfdb.serve_buckets, for ``backend``: the service's device
    type, else the process's) for a recorded best-known ladder and falls
    through to DEFAULT_BUCKETS bit-identically when the database, the
    row, or a valid ``serve_buckets`` knob is absent."""
    if buckets is not None:
        return tuple(sorted(int(b) for b in buckets))
    from flake16_framework_tpu_torch.obs import perfdb

    recorded = perfdb.serve_buckets(backend)
    if recorded:
        return tuple(sorted(int(b) for b in recorded))
    return DEFAULT_BUCKETS


class LatencyStats:
    """Thread-safe bounded ring of request latencies (ms) with p50/p99
    snapshots — the service's latency instrument."""

    def __init__(self, window=2048):
        self._window = int(window)
        self._lock = threading.Lock()
        self._ring = []
        self._idx = 0
        self._count = 0

    def record(self, ms):
        with self._lock:
            if len(self._ring) < self._window:
                self._ring.append(float(ms))
            else:
                self._ring[self._idx] = float(ms)
                self._idx = (self._idx + 1) % self._window
            self._count += 1

    def snapshot(self):
        with self._lock:
            vals = sorted(self._ring)
            count = self._count
        if not vals:
            return {"count": 0, "p50_ms": None, "p99_ms": None}

        def pct(p):
            return vals[min(len(vals) - 1, round(p * (len(vals) - 1)))]

        return {"count": count, "p50_ms": round(pct(0.50), 3),
                "p99_ms": round(pct(0.99), 3)}


class ScoringService:
    """The always-on scoring service (in-process form), on ``device``
    (``cuda`` unless the caller asks for another; raises without CUDA).

    ``with ScoringService(registry) as svc: svc.score(mid, x)`` — or
    ``start()``/``stop()`` explicitly. Admission raises
    :class:`RequestRejected` (unknown/quarantined model, bad kind,
    oversize batch, full queue); a dispatch the dispatch guard abandoned
    re-raises from ``result()`` as DispatchAbandoned.
    """

    def __init__(self, registry, *, buckets=None, max_inflight=2,
                 queue_max=256, guard=None, device=None, slo=None,
                 metrics_port=None):
        self.registry = registry
        self.store = ExecutableStore(registry, device=device)
        self.device = self.store.device
        self.buckets = resolve_buckets(buckets, self.device.type)
        self.requests = RequestQueue(maxsize=queue_max)
        self.latency = LatencyStats()
        # ``slo`` is the declared-objectives config (True = defaults,
        # None = no SLO loop and no new hot-path work).
        self.slo = None
        if slo is not None and slo is not False:
            self.slo = SLOMonitor(SLOConfig() if slo is True else slo)
        self.batcher = Microbatcher(
            self.store, self.requests, buckets=self.buckets,
            max_inflight=max_inflight, guard=guard, stats=self.latency,
            monitor=self.slo)
        # ``metrics_port`` stands the Prometheus exporter up beside the
        # service (0 = ephemeral; None = off, same contract as the SLO).
        self.metrics_port = metrics_port
        self.metrics = None

    # -- lifecycle -------------------------------------------------------

    def start(self):
        """Warm every (model, kind, bucket), then start the batcher
        threads. Any warm failure propagates — an unservable registry
        must fail here, not at the first request."""
        with obs.span("serve.warm", key=f"models={len(self.registry)}"):
            for model in self.registry.models():
                self.store.warm(model, self.buckets)
        obs.manifest_update(
            verb="serve", serve_models=len(self.registry),
            serve_buckets=list(self.buckets),
            serve_device=str(self.device))
        if self.metrics_port is not None:
            self.metrics = self._make_metrics_server(self.metrics_port)
            self.metrics.start()
        self.batcher.start()
        return self

    def stop(self):
        self.requests.close()
        self.batcher.stop()
        if self.metrics is not None:
            self.metrics.stop()
            self.metrics = None

    def _make_metrics_server(self, port):
        """Registry with the process-wide sources plus this service's
        live serve/SLO sources, behind a loopback HTTP thread."""
        from flake16_framework_tpu_torch.obs.metrics import (
            MetricsRegistry, MetricsServer, register_process_sources,
        )

        reg = MetricsRegistry()
        register_process_sources(reg)
        reg.register("f16_serve_queue_depth", self.requests.depth,
                     help="Requests queued awaiting coalescing.")
        reg.register("f16_serve_inflight",
                     lambda: self.batcher.inflight,
                     help="Microbatches currently inside a dispatch.")
        reg.register("f16_serve_quarantined",
                     lambda: len(self.batcher.quarantined),
                     help="Models quarantined after abandoned dispatches.")
        reg.register("f16_serve_requests_total",
                     lambda: self.latency.snapshot()["count"],
                     kind="counter",
                     help="Requests completed since service start.")
        reg.register("f16_serve_p50_ms",
                     lambda: self.latency.snapshot()["p50_ms"],
                     help="p50 request latency over the rolling window, "
                          "ms.")
        reg.register("f16_serve_p99_ms",
                     lambda: self.latency.snapshot()["p99_ms"],
                     help="p99 request latency over the rolling window, "
                          "ms.")
        if self.slo is not None:
            reg.register("f16_slo_burn_fast",
                         lambda: self.slo.burn_fast,
                         help="SLO burn rate over the fast window "
                              "(1.0 = on budget).")
            reg.register("f16_slo_burn_slow",
                         lambda: self.slo.burn_slow,
                         help="SLO burn rate over the slow window.")
            reg.register("f16_slo_shedding",
                         lambda: int(self.slo.shedding),
                         help="1 while admission is shedding load.")
            reg.register("f16_serve_shed_total",
                         lambda: self.slo.shed_total, kind="counter",
                         help="Admissions rejected by SLO shedding.")
            reg.register("f16_slo_time_in_degraded_seconds",
                         lambda: self.slo.summary()["time_in_degraded_s"],
                         help="Cumulative wall seconds spent shedding.")
        return MetricsServer(reg, port=port)

    def slo_summary(self):
        """The SLO rollup (None without an SLO loop)."""
        return self.slo.summary() if self.slo is not None else None

    def drain(self, deadline_s=10.0):
        """Graceful drain (see module docstring): close admission, fail
        queued requests with RetriableRejection, let in-flight batches
        complete within ``deadline_s``, then flush durable state. Past
        the deadline, escalate to checkpoint-and-abort (handed-off
        batches fail; the flush still runs). Returns the accounting
        dict the drain drill asserts on: phase (complete|abort) plus
        completed / rejected / aborted request counts."""
        t0 = time.perf_counter()
        done_before = self.latency.snapshot()["count"]
        obs.event("drain", phase="begin", deadline_s=float(deadline_s))
        self.requests.close()
        queued = self.requests.drain_pending()
        rejection = RetriableRejection(
            "service draining; resubmit to the replacement service")
        for r in queued:
            r._fail(rejection)
        clean = self.batcher.stop(timeout=deadline_s)
        aborted = 0
        if not clean:
            aborted = self.batcher.abort_pending(ServeError(
                f"drain deadline ({deadline_s}s) exceeded; "
                f"batch aborted before dispatch"))
        self.flush()
        acct = {
            "phase": "complete" if clean else "abort",
            "completed": self.latency.snapshot()["count"] - done_before,
            "rejected": len(queued),
            "aborted": aborted,
            "wall_s": round(time.perf_counter() - t0, 3),
        }
        obs.event("drain", phase=acct["phase"],
                  completed=acct["completed"], rejected=acct["rejected"],
                  aborted=acct["aborted"])
        return acct

    def flush(self):
        """Flush durable serve state: the registry index and the warm
        manifest (signatures computed without running anything — the
        reload-warm contract's check value). Returns the manifest path
        (None for a rootless registry)."""
        manifest_path = None
        if getattr(self.registry, "root", None):
            self.registry.flush()
            manifest_path = os.path.join(self.registry.root, MANIFEST_FILE)
            self.store.flush_manifest(
                manifest_path, self.registry.models(), self.buckets)
        obs.manifest_update(
            verb="serve", serve_models=len(self.registry),
            serve_manifest=manifest_path)
        return manifest_path

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API ------------------------------------------------------

    def _admit(self, model_id, x, kind):
        if self.slo is not None and self.slo.shedding:
            # Bounded-admission rejection: while the burn-rate breach
            # stands, new work is refused at the door — the queue must
            # never grow into the latency it is supposed to cure.
            # Retriable: nothing was queued or dispatched.
            self.slo.record_shed()
            raise RetriableRejection(
                "shedding load (SLO burn-rate breach); retry later")
        if kind not in KINDS:
            raise RequestRejected(f"unknown kind: {kind!r} (want {KINDS})")
        model = self.registry.get(model_id)
        if model is None:
            raise RequestRejected(f"model not registered: {model_id}")
        if model_id in self.batcher.quarantined:
            raise RequestRejected(
                f"model quarantined: {model_id} "
                f"[{self.batcher.quarantined[model_id]['fault_class']}]")
        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        n_cols = len(model.cols)
        if x.ndim != 2:
            raise RequestRejected(f"want [n, features], got {x.shape}")
        if x.shape[1] != n_cols:
            if x.shape[1] > max(model.cols):
                x = x[:, list(model.cols)]  # full feature rows: select
            else:
                raise RequestRejected(
                    f"feature width {x.shape[1]} matches neither the "
                    f"config's {n_cols} columns nor the full set")
        if not 1 <= x.shape[0] <= self.buckets[-1]:
            raise RequestRejected(
                f"batch rows {x.shape[0]} outside [1, {self.buckets[-1]}]"
                " (split client-side)")
        return model, x

    def submit(self, model_id, x, kind="predict", trace_parent=None):
        """Admit one request; returns the :class:`ScoreRequest` future.
        A trace context is minted here (``F16_TRACE_SAMPLE``) and rides
        the request to the response. ``trace_parent`` is the context a
        fleet worker received on the wire: the request then adopts the
        router's trace id instead of flipping a second sampling coin."""
        _, x = self._admit(model_id, x, kind)
        trace = (obs.adopt_trace(trace_parent) if trace_parent
                 else obs.mint_trace())
        return self.requests.submit(
            ScoreRequest(model_id, x, kind=kind, trace=trace))

    def score(self, model_id, x, kind="predict", timeout=None):
        """Synchronous submit+result."""
        return self.submit(model_id, x, kind=kind).result(timeout)

    def stats(self):
        """The service's state: models, requests answered and the latency
        ring's p50/p99, queue depth, quarantined models, and where an
        answered request waited before its dispatch, mean ms
        (``Microbatcher.wait_stats``): in the queue (``queue_wait_ms``)
        and in the handoff to a dispatcher (``handoff_wait_ms``)."""
        snap = self.latency.snapshot()
        return {
            "models": self.registry.ids(),
            "requests": snap["count"],
            "p50_ms": snap["p50_ms"],
            "p99_ms": snap["p99_ms"],
            "queue_depth": self.requests.depth(),
            "quarantined": dict(self.batcher.quarantined),
            **self.batcher.wait_stats(),
        }
