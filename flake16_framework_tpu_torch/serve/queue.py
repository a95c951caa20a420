"""Async request queue: submit -> future, with bounded depth (a copy of
the JAX package's ``serve/queue.py``).

The queue is the service's only admission point. ``submit`` either
accepts a request (returning it — the request doubles as its own
future: ``result()`` blocks on completion) or raises
:class:`RequestRejected` immediately when the queue is full or closed —
bounded memory and a fast-fail signal under overload, never silent
buffering.

``take_batch`` is the microbatcher's side: it blocks for the first
request, then greedily drains FIFO-ordered requests for the SAME
(model, kind) up to the row budget. There is no artificial gather
delay — microbatching emerges from dispatch backpressure (while the
bounded in-flight dispatches are busy, the queue accumulates, and the
next ``take_batch`` coalesces what arrived).

Nothing here touches the device.
"""

import threading
import time


class ServeError(RuntimeError):
    """Base class for scoring-service errors. ``retriable`` is the
    client contract: True means nothing was dispatched on the request's
    behalf, so resubmitting (to this or a replacement service) is safe
    and expected; False means the same request would fail again."""

    retriable = False


class RequestRejected(ServeError):
    """Request refused at admission (queue full/closed, unknown or
    quarantined model, oversize batch)."""


class RetriableRejection(RequestRejected):
    """Request refused because the service is DRAINING (e.g. SIGTERM
    landed): it was queued but never handed to a dispatcher, so the
    client may safely resubmit to the restarted or replacement
    service. The drain path fails every unstarted request with this —
    never a silent drop."""

    retriable = True


class ScoreRequest:
    """One scoring request and its completion future. ``trace`` is the
    request's trace context (``obs.mint_trace()`` or ``obs.adopt_trace``:
    a trace_id/span_id dict, or None when unsampled or off), carried
    queue→batcher→dispatch so the batcher can stamp per-request spans."""

    __slots__ = ("kind", "model_id", "x", "n", "t_submit", "trace",
                 "_done", "_out", "_exc")

    def __init__(self, model_id, x, kind="predict", trace=None):
        self.model_id = model_id
        self.x = x
        self.n = int(x.shape[0])
        self.kind = kind
        self.t_submit = time.perf_counter()
        self.trace = trace
        self._done = threading.Event()
        self._out = None
        self._exc = None

    def _complete(self, out):
        self._out = out
        self._done.set()

    def _fail(self, exc):
        self._exc = exc
        self._done.set()

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Block until the dispatch completes; re-raises the dispatch's
        failure (e.g. resilience.DispatchAbandoned after the guard
        exhausted its attempts)."""
        if not self._done.wait(timeout):
            raise ServeError(
                f"request not completed within {timeout}s "
                f"({self.model_id}/{self.kind})")
        if self._exc is not None:
            raise self._exc
        return self._out


class RequestQueue:
    """Bounded FIFO of :class:`ScoreRequest` with condition-variable
    handoff to the batcher's collector thread."""

    def __init__(self, maxsize=256):
        self.maxsize = int(maxsize)
        self._items = []
        self._cond = threading.Condition()
        self._closed = False

    def submit(self, request):
        with self._cond:
            if self._closed:
                # Closed means draining/stopped: nothing was dispatched,
                # so the rejection is retriable against a replacement.
                raise RetriableRejection(
                    "queue closed (draining); resubmit to the "
                    "replacement service")
            if len(self._items) >= self.maxsize:
                raise RequestRejected(
                    f"queue full ({self.maxsize} requests)")
            self._items.append(request)
            self._cond.notify()
        return request

    def take_batch(self, max_rows, wait_s=0.05):
        """Wait up to ``wait_s`` for a first request, then greedily take
        same-(model, kind) FIFO requests while total rows fit in
        ``max_rows``. Returns a (possibly empty) list; empty means the
        wait timed out (the collector loop re-checks for shutdown)."""
        with self._cond:
            if not self._items:
                self._cond.wait(wait_s)
            if not self._items:
                return []
            head = self._items[0]
            batch, rows, keep = [], 0, []
            for req in self._items:
                if (req.model_id == head.model_id
                        and req.kind == head.kind
                        and rows + req.n <= max_rows):
                    batch.append(req)
                    rows += req.n
                else:
                    keep.append(req)
            self._items = keep
            return batch

    def depth(self):
        with self._cond:
            return len(self._items)

    def close(self):
        """Stop admitting; queued requests still drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain_pending(self):
        """Pop and return every queued-but-uncollected request. The
        drain path calls this right after ``close()`` and fails each
        with :class:`RetriableRejection` — these were never dispatched,
        so the rejection is the retry signal, not an error."""
        with self._cond:
            items, self._items = self._items, []
            return items
