"""Shape-bucketed microbatcher: the serving layer's dispatch engine.

One collector thread drains the request queue (coalescing FIFO
same-(model, kind) requests), pads each coalesced batch to the smallest
registered bucket shape, and hands it to a bounded pool of dispatcher
threads through a ``maxsize=max_inflight`` handoff queue — the handoff
blocking IS the backpressure that lets the request queue accumulate and
the next coalesce grow. Every dispatch goes through the dispatch guard
(retries, ``oom`` -> ``empty_cache``, abandon), built with the store's
device so that a CUDA error surfaces inside it; a dispatch the guard
abandons quarantines the model. There is no fallback device or arm.
With an SLO monitor, every completed or failed request is observed and
the burn evaluated once a batch; the dispatch span, the per-request spans
of sampled requests, the request counter and the queue, inflight and
latency gauges go to the telemetry (no-ops unless it is on).

The ONLY device->host transfer in this module is the single copy of a
completed microbatch's result — one crossing amortized over the batch's
requests.
"""

import queue as _stdqueue
import threading
import time

import numpy as np
import torch

from flake16_framework_tpu_torch import obs
from flake16_framework_tpu_torch.resilience import guard as _guard
from flake16_framework_tpu_torch.serve.queue import ServeError


class Microbatcher:
    """Collector + bounded dispatcher pool between a
    :class:`~flake16_framework_tpu_torch.serve.queue.RequestQueue` and an
    :class:`~flake16_framework_tpu_torch.serve.store.ExecutableStore`."""

    def __init__(self, store, requests, *, buckets=(8, 32, 128),
                 max_inflight=2, guard=None, stats=None, monitor=None):
        self.store = store
        self.requests = requests
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.max_rows = self.buckets[-1]
        self.guard = guard if guard is not None else _guard.default_guard(
            device=store.device)
        self.stats = stats
        self.monitor = monitor  # obs.slo.SLOMonitor (None = no SLO loop)
        self.quarantined = {}
        # Guards quarantined writes: every dispatcher-pool worker can
        # quarantine on an abandoned dispatch. Admission reads stay
        # lock-free — a stale miss admits one request that fails with the
        # same DispatchAbandoned, which is benign.
        self._quarantine_lock = threading.Lock()
        self.inflight = 0  # dispatches currently inside _run_batch
        self._inflight_lock = threading.Lock()
        self._handoff = _stdqueue.Queue(maxsize=int(max_inflight))
        self._stop = threading.Event()
        self._threads = []
        self._max_inflight = int(max_inflight)

    # -- lifecycle -------------------------------------------------------

    def start(self):
        self._stop.clear()
        self._threads = [threading.Thread(
            target=self._collect, name="serve-collector", daemon=True)]
        self._threads += [threading.Thread(
            target=self._dispatch_loop, name=f"serve-dispatch-{i}",
            daemon=True) for i in range(self._max_inflight)]
        for t in self._threads:
            t.start()

    def stop(self, timeout=5.0):
        """Stop collecting; in-flight and handed-off batches drain.
        Returns True when every worker thread exited within ``timeout``
        (the shared deadline, not per-thread) — the drain path
        escalates to :meth:`abort_pending` on False."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        clean = True
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
            clean = clean and not t.is_alive()
        self._threads = []
        return clean

    def abort_pending(self, exc):
        """Fail every handed-off-but-unstarted batch with ``exc`` and
        return the request count — the drain deadline's
        checkpoint-and-abort escalation. A request wedged INSIDE a
        dispatch belongs to its (daemon) worker and is not reclaimed
        here; its future completes or fails from the guard."""
        n = 0
        while True:
            try:
                batch = self._handoff.get_nowait()
            except _stdqueue.Empty:
                return n
            for r in batch:
                r._fail(exc)
                n += 1
            self._handoff.task_done()

    # -- threads ---------------------------------------------------------

    def _collect(self):
        while not self._stop.is_set():
            batch = self.requests.take_batch(self.max_rows, wait_s=0.05)
            if batch:
                self._handoff.put(batch)

    def _dispatch_loop(self):
        if self.store.device.type == "cuda":
            # A new thread starts on the current device, not on the
            # service's: set it explicitly.
            torch.cuda.set_device(self.store.device)
        while True:
            try:
                batch = self._handoff.get(timeout=0.05)
            except _stdqueue.Empty:
                if self._stop.is_set():
                    return
                continue
            with self._inflight_lock:
                self.inflight += 1
            try:
                self._run_batch(batch)
            finally:
                with self._inflight_lock:
                    self.inflight -= 1
                self._handoff.task_done()

    # -- dispatch --------------------------------------------------------

    def _bucket_for(self, rows):
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1]

    def _fail_batch(self, batch, exc):
        for r in batch:
            r._fail(exc)
        if self.monitor is not None:
            for _ in batch:
                self.monitor.observe(error=True)
            self.monitor.evaluate()

    def _run_batch(self, batch):
        t_start = time.perf_counter()
        wall_start = time.time()
        req0 = batch[0]
        model = self.store.registry.get(req0.model_id)
        if model is None:
            self._fail_batch(batch, ServeError(
                f"model not registered: {req0.model_id}"))
            return
        if req0.model_id in self.quarantined:
            self._fail_batch(batch, ServeError(
                f"model quarantined: {req0.model_id} "
                f"[{self.quarantined[req0.model_id]['fault_class']}]"))
            return

        rows = sum(r.n for r in batch)
        bucket = self._bucket_for(rows)
        xpad = np.zeros((bucket, len(model.cols)), dtype=np.float32)
        off = 0
        for r in batch:
            xpad[off:off + r.n] = r.x
            off += r.n

        def thunk():
            return self.store.call(model, req0.kind, xpad)

        # Batch fan-in as span links: the coalesced requests' trace ids
        # ride the dispatch span, joining each sampled request to the
        # microbatch that carried it.
        links = [r.trace["trace_id"] for r in batch if r.trace]
        span_fields = {"rows": rows, "bucket": bucket,
                       "coalesced": len(batch)}
        if links:
            span_fields["links"] = links
        try:
            with obs.span("serve.dispatch",
                          key=f"{req0.model_id}/{req0.kind}",
                          **span_fields):
                with obs.xprof_trace(f"serve-{req0.kind}",
                                     self.store.device):
                    out = self.guard.call(
                        thunk, config_index=model.config_index,
                        label=f"serve:{req0.model_id}:{req0.kind}")
        except Exception as e:
            if isinstance(e, _guard.DispatchAbandoned):
                with self._quarantine_lock:
                    self.quarantined[req0.model_id] = {
                        "fault_class": e.fault_class,
                        "attempts": len(e.attempts),
                        "kind": req0.kind,
                    }
            self._fail_batch(batch, e)
            return

        # The one device->host crossing of a microbatch.
        host = out.cpu().numpy()  # f16lint: disable=J601
        t_done = time.perf_counter()
        off = 0
        for r in batch:
            r._complete(host[off:off + r.n].copy())
            off += r.n
            latency_ms = (t_done - r.t_submit) * 1000.0
            if self.stats is not None:
                self.stats.record(latency_ms)
            if self.monitor is not None:
                self.monitor.observe(latency_ms=latency_ms)
            if r.trace:
                # Per-request spans: the queue leg ends at dispatch
                # start, the request leg now. An adopted cross-process
                # context carries parent_id (the router's span).
                tctx = {"trace_id": r.trace["trace_id"],
                        "span_id": r.trace["span_id"]}
                if r.trace.get("parent_id"):
                    tctx["parent_id"] = r.trace["parent_id"]
                obs.event("span", name="serve.request.queue",
                          wall_s=round(t_start - r.t_submit, 6),
                          cold=False, ts=round(wall_start, 4),
                          model_id=r.model_id, req_kind=r.kind, **tctx)
                obs.event("span", name="serve.request",
                          wall_s=round(t_done - r.t_submit, 6),
                          cold=False,
                          model_id=r.model_id, req_kind=r.kind, rows=r.n,
                          coalesced=len(batch), **tctx)
        obs.counter_add("serve.requests", len(batch))
        obs.gauge("serve.queue_depth", self.requests.depth())
        obs.gauge("serve.inflight", self.inflight)
        if self.stats is not None:
            snap = self.stats.snapshot()
            obs.gauge("serve.p50_ms", snap["p50_ms"])
            obs.gauge("serve.p99_ms", snap["p99_ms"])
        if self.monitor is not None:
            self.monitor.evaluate()
