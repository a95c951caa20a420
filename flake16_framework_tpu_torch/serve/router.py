"""FleetRouter: the health-gated, hedging, failing-over front end of
the serving fleet (the JAX package's ``serve/router.py`` for this
package; it speaks the same wire, so it routes to either package's
workers).

The router duck-types the :class:`ScoringService` client API —
``score`` / ``submit`` / ``latency`` / ``stats()`` — so every existing
load generator (``sustained_load``, ``hold_until_signal``) runs against a
W-worker fleet unchanged. Under the API:

**Health gating.** Each worker link carries the worker's pushed
heartbeats (serve/fleet.py streams queue depth, inflight, p50/p99, SLO
burn rates, shedding). A worker is ROUTABLE only while its link is up,
its last heartbeat is fresher than ``F16_FLEET_STALL_S``, it is not
shedding (SLO burn breach — the router respects the worker's own
admission verdict instead of hammering a breached replica), and it is
not draining. Selection is least-loaded: min(pending + queue_depth)
over routable links.

**Hedging.** ``score`` waits ``F16_FLEET_HEDGE_MS`` on the request
future, then re-sends the SAME request id to a different worker —
scoring is idempotent, so racing two replicas against a straggler is
free except for the duplicate's compute. The first response completes
the future; the loser's response finds the id already done and is
COALESCED (counted, dropped — never double-billed to the client).
Hedge pacing rides the resilience backoff machinery
(resilience/guard.BackoffPolicy): hedge k waits one backoff step
longer than hedge k-1.

**Failover.** A dead link (EOF/ECONNRESET — SIGKILL closes the socket
promptly) orphans its pending requests; each orphan that is not
already done is re-dispatched to a surviving worker after a
BackoffPolicy delay, bounded by the policy's ``max_attempts``. A
worker's RETRIABLE error response (drain rejection, shed) re-dispatches
the same way — nothing was dispatched on the request's behalf, the
ServeError contract — which is exactly why rolling restarts are
zero-drop. Failover timing is recorded: ``failovers`` keeps
{worker, t_detect, t_recovered, n_orphans} per event and
``last_failover_s`` is the window from detection to the last orphan
settled.

**Rolling restart.** ``rolling_restart`` walks workers one at a time:
mark the link draining (routing stops), send the ``drain`` op (the
worker runs the service's graceful drain and exits 0), wait for the
fleet manager's free respawn, reconnect, wait for a fresh heartbeat,
move on. Admission at the router never closes; queued-but-unstarted
requests the drain rejects come back retriable and re-route. The drill
asserts 0 client-visible errors across the whole walk.

**Telemetry.** Every submit mints an ``obs.mint_trace`` context;
sampled requests carry it across the wire (serve/wire.py trace fields)
so worker spans adopt the router's trace id, and the router's own
``fleet.request`` span plus its hedge / hedge-coalesced / redispatch
``fleet`` events land on the SAME trace. A fleet-level SLO monitor
(obs/slo.SLOMonitor, ``degrade=False`` — it accounts, it never sheds) folds the router-observed latency/error
stream into burn rates; a worker whose heartbeat carries a hot local
burn is DEPRIORITIZED in selection (a load penalty, not a gate — it
still serves when it is the only one standing), and rolling restarts
are annotated with the error-budget spend their window cost.

Lock discipline: the router's locks form a flat order — a link's ``_lock`` guards that link's pending map + heartbeat
state, the router's ``_lock`` guards counters/failover records, a
request's internal lock is a completion leaf. No path holds two of
them except link→request (completion under the link's pop) and
router→nothing, a cycle-free order.
"""

import collections
import os
import random
import threading
import time

import queue as _stdqueue

from flake16_framework_tpu_torch import obs
from flake16_framework_tpu_torch.obs import slo as _slo
from flake16_framework_tpu_torch.resilience import guard as _guard
from flake16_framework_tpu_torch.serve import wire
from flake16_framework_tpu_torch.serve.queue import (
    RequestRejected, RetriableRejection, ServeError,
)
from flake16_framework_tpu_torch.serve.service import LatencyStats

# Straggler timeout before a hedge duplicate is sent, milliseconds.
HEDGE_ENV = "F16_FLEET_HEDGE_MS"
DEFAULT_HEDGE_MS = 400.0

# Heartbeat staleness horizon, seconds: a worker silent this long is
# un-routable (stalled or dead) even while its socket stays open.
STALL_ENV = "F16_FLEET_STALL_S"
DEFAULT_STALL_S = 2.0

# SLO deprioritization: a worker heartbeating a fast-window
# burn over 1.0 (spending faster than budget) has each excess burn unit
# priced as this many queued requests in the least-loaded pick. High
# enough to steer load away from a hot replica before it breaches and
# sheds; bounded (see WorkerLink.load) so a burning worker is never
# priced out entirely — deprioritized, not gated.
BURN_PENALTY_LOAD = 8.0

# Sliding window for the fleet requests-per-second aggregate, seconds.
RPS_WINDOW_S = 10.0


def hedge_ms_from_env(environ=None):
    env = os.environ if environ is None else environ
    raw = env.get(HEDGE_ENV, "")
    try:
        return float(raw) if raw else DEFAULT_HEDGE_MS
    except ValueError:
        return DEFAULT_HEDGE_MS


def stall_s_from_env(environ=None):
    env = os.environ if environ is None else environ
    raw = env.get(STALL_ENV, "")
    try:
        val = float(raw) if raw else DEFAULT_STALL_S
    except ValueError:
        val = DEFAULT_STALL_S
    return max(0.1, val)


class NoRoutableWorker(RetriableRejection):
    """Every worker is down/stalled/draining/shedding — retriable: the
    request was never dispatched anywhere."""


class FleetRequest:
    """One routed request's future. ``_complete``/``_fail`` return False
    when the request already finished — the hedge-coalescing check."""

    __slots__ = ("rid", "model_id", "x", "kind", "trace", "t_submit",
                 "attempts", "failover", "_evt", "_out", "_exc", "_lock")

    def __init__(self, rid, model_id, x, kind, trace=None):
        self.rid = rid
        self.model_id = model_id
        self.x = x
        self.kind = kind
        self.trace = trace   # obs.mint_trace ctx (None = unsampled)
        self.t_submit = time.perf_counter()
        self.attempts = []   # worker indices this request was sent to
        self.failover = False  # orphaned by a link death (accounting)
        self._evt = threading.Event()
        self._out = None
        self._exc = None
        self._lock = threading.Lock()

    def done(self):
        return self._evt.is_set()

    def _complete(self, out):
        with self._lock:
            if self._evt.is_set():
                return False
            self._out = out
            self._evt.set()
            return True

    def _fail(self, exc):
        with self._lock:
            if self._evt.is_set():
                return False
            self._exc = exc
            self._evt.set()
            return True

    def wait(self, timeout=None):
        return self._evt.wait(timeout)

    def result(self, timeout=None):
        if not self._evt.wait(timeout):
            raise TimeoutError(
                f"fleet request {self.rid} not completed in {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._out


def _rebuild_error(resp):
    """A worker's error response as the exception the in-process service
    would have raised — retriable flag preserved across the wire."""
    name = resp.get("error_type", "ServeError")
    msg = resp.get("error", "worker error")
    if resp.get("retriable"):
        return RetriableRejection(msg)
    if name == "RequestRejected":
        return RequestRejected(msg)
    return ServeError(f"[{name}] {msg}")


class WorkerLink:
    """The router's end of one worker connection: socket + send lock,
    reader thread, pending map, last-pushed heartbeat."""

    def __init__(self, index, socket_path, router):
        self.index = index
        self.socket_path = socket_path
        self.router = router
        self._sock = None
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()   # pending + hb + up/draining
        self.pending = {}               # rid -> FleetRequest
        self.hb = {}
        self.last_hb = 0.0
        self.up = False
        self.draining = False
        self._reader = None

    # -- connection lifecycle --------------------------------------------

    def connect(self, timeout=1.0):
        sock = wire.connect_unix(self.socket_path, timeout=timeout)
        with self._lock:
            self._sock = sock
            self.up = True
            self.draining = False
            # A fresh link is routable until the first heartbeat proves
            # otherwise; stamping now keeps the stall gate from
            # rejecting a just-respawned worker.
            self.last_hb = time.monotonic()
            self.hb = {}
        self._reader = threading.Thread(
            target=self._read_loop, args=(sock,),
            name=f"fleet-link-{self.index}", daemon=True)
        self._reader.start()

    def close(self):
        with self._lock:
            sock, self._sock = self._sock, None
            self.up = False
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _mark_down(self, sock):
        """Link death: flip down, orphan the pending map, hand the
        orphans to the router's failover path."""
        with self._lock:
            if self._sock is not sock:
                return  # an older incarnation's reader; already handled
            self._sock = None
            self.up = False
            orphans = list(self.pending.values())
            self.pending.clear()
        try:
            sock.close()
        except OSError:
            pass
        if orphans:
            self.router._on_link_down(self, orphans)

    # -- I/O ---------------------------------------------------------------

    def send_request(self, req, msg):
        """Register ``req`` pending and ship the frame; raises OSError
        (after marking the link down) when the socket is dead."""
        with self._lock:
            if not self.up or self._sock is None:
                raise OSError(f"link {self.index} is down")
            self.pending[req.rid] = req
            sock = self._sock
        try:
            with self._send_lock:
                wire.send_msg(sock, msg)
        except OSError:
            self._mark_down(sock)
            raise

    def send_control(self, msg):
        with self._lock:
            sock = self._sock
        if sock is None:
            raise OSError(f"link {self.index} is down")
        with self._send_lock:
            wire.send_msg(sock, msg)

    def _read_loop(self, sock):
        while True:
            try:
                msg = wire.recv_msg(sock)
            except (wire.WireError, OSError):
                msg = None
            if msg is None:
                self._mark_down(sock)
                return
            if not isinstance(msg, dict):
                continue
            if "hb" in msg:
                with self._lock:
                    self.hb = msg["hb"]
                    self.last_hb = time.monotonic()
                continue
            rid = msg.get("id")
            with self._lock:
                req = self.pending.pop(rid, None)
            if req is None:
                # A control response (drain/ping ack) or a response for
                # a request another link already completed.
                self.router._on_unmatched(self.index, msg)
                continue
            self.router._on_response(self, req, msg)

    # -- health ----------------------------------------------------------

    def routable(self, stall_s, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            return (self.up and not self.draining
                    and (now - self.last_hb) < stall_s
                    and not self.hb.get("shedding", False))

    def load(self):
        """The selection metric: router-side pending + worker-reported
        queue depth and inflight, plus the SLO deprioritization penalty
        — excess fast-window burn the worker heartbeats is
        priced as queued work, capped at 4 burn units so a hot replica
        is steered around, never starved."""
        with self._lock:
            base = (len(self.pending) + self.hb.get("queue_depth", 0)
                    + self.hb.get("inflight", 0))
            burn = self.hb.get("burn_fast", 0.0) or 0.0
        if burn > 1.0:
            base += min(burn - 1.0, 4.0) * BURN_PENALTY_LOAD
        return base

    def snapshot(self):
        with self._lock:
            return {"index": self.index, "up": self.up,
                    "draining": self.draining,
                    "pending": len(self.pending),
                    "hb_age_s": round(time.monotonic() - self.last_hb, 3),
                    "hb": dict(self.hb)}


class FleetRouter:
    """See module docstring. ``fleet`` is a serve/fleet.Fleet (used for
    respawn-aware rolling restarts); ``socket_paths`` alone suffices
    for routing/hedging/failover against externally managed workers."""

    def __init__(self, fleet=None, *, socket_paths=None, hedge_ms=None,
                 stall_s=None, backoff=None, max_attempts=None,
                 environ=None, seed=0, slo=None):
        env = os.environ if environ is None else environ
        if fleet is None and socket_paths is None:
            raise ValueError("FleetRouter needs a fleet or socket_paths")
        self.fleet = fleet
        paths = (socket_paths if socket_paths is not None
                 else fleet.socket_paths())
        self.links = [WorkerLink(i, p, self) for i, p in enumerate(paths)]
        self.hedge_ms = (hedge_ms_from_env(env) if hedge_ms is None
                         else float(hedge_ms))
        self.stall_s = (stall_s_from_env(env) if stall_s is None
                        else float(stall_s))
        self.backoff = backoff or _guard.policy_from_env(env)
        self.max_attempts = (self.backoff.max_attempts + 1
                             if max_attempts is None else int(max_attempts))
        self.latency = LatencyStats()
        self._rng = random.Random(seed)
        self._lock = threading.Lock()   # counters + failover records
        self._rid = 0
        self.completed = 0
        self.hedges = 0
        self.hedge_coalesced = 0
        self.redispatches = 0
        self.failovers = []             # {worker, t_detect, t_recovered,
        self._open_failover = None      #  n_orphans}
        self._repair_q = _stdqueue.Queue()
        self._stop = threading.Event()
        self._threads = []
        # Fleet-level SLO accounting: the merged latency/
        # error stream every worker's responses flow through, folded by
        # one monitor that NEVER sheds or degrades (accounting + the
        # load()-side deprioritization signal; admission stays open —
        # per-worker monitors own shedding). ``slo=False`` disables;
        # an SLOConfig customizes the objectives.
        self.slo = None
        if slo is not False:
            cfg = slo if isinstance(slo, _slo.SLOConfig) \
                else _slo.SLOConfig(degrade=False)
            cfg.degrade = False  # the fleet monitor must never actuate
            self.slo = _slo.SLOMonitor(cfg)
        # (monotonic ts, completed) samples the maintenance loop appends
        # ~1/s — the fleet_rps aggregate's sliding window.
        self._rps_window = collections.deque()

    # -- lifecycle -------------------------------------------------------

    def start(self):
        for link in self.links:
            try:
                link.connect()
            except OSError:
                pass  # the maintenance loop keeps trying
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._maintenance_loop,
                             name="fleet-router-maint", daemon=True),
            threading.Thread(target=self._repair_loop,
                             name="fleet-router-repair", daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(5.0)
        self._threads = []
        for link in self.links:
            link.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- maintenance (reconnect + failover recovery bookkeeping) ---------

    def _maintenance_loop(self):
        next_obs = 0.0
        while not self._stop.wait(0.1):
            for link in self.links:
                with link._lock:
                    down = not link.up
                if down and not self._stop.is_set():
                    try:
                        link.connect(timeout=0.5)
                    except OSError:
                        continue
            now = time.monotonic()
            if now >= next_obs:
                next_obs = now + 1.0
                self._observe_fleet(now)

    def _observe_fleet(self, now=None):
        """The ~1 Hz fleet accounting tick: advance the rps window,
        evaluate the fleet SLO monitor (its breach/recovered ``slo``
        events are the fleet-level burn witness), and stamp the fleet
        aggregate gauges — all no-ops beyond an is-None check when
        telemetry is off."""
        now = time.monotonic() if now is None else now
        snaps = [link.snapshot() for link in self.links]
        with self._lock:
            self._rps_window.append((now, self.completed))
            while len(self._rps_window) > 2 \
                    and now - self._rps_window[0][0] > RPS_WINDOW_S:
                self._rps_window.popleft()
        if self.slo is not None:
            self.slo.evaluate()
        obs.gauge("fleet.rps", self.fleet_rps())
        obs.gauge("fleet.queue_depth",
                  sum(s["hb"].get("queue_depth", 0) for s in snaps))
        obs.gauge("fleet.inflight",
                  sum(s["hb"].get("inflight", 0) for s in snaps))
        obs.gauge("fleet.workers_up", sum(1 for s in snaps if s["up"]))

    def fleet_rps(self):
        """Completed requests per second over the sliding window the
        maintenance loop samples (0.0 until two samples exist)."""
        with self._lock:
            if len(self._rps_window) < 2:
                return 0.0
            t0, c0 = self._rps_window[0]
            t1, c1 = self._rps_window[-1]
        if t1 <= t0:
            return 0.0
        return round((c1 - c0) / (t1 - t0), 3)

    def _repair_loop(self):
        """Re-dispatch orphaned/rejected requests off the reader threads
        (the reader must never sleep a backoff)."""
        while not self._stop.is_set():
            try:
                req, attempt, exclude = self._repair_q.get(timeout=0.1)
            except _stdqueue.Empty:
                continue
            if req.done():
                self._note_recovered(req)
                continue
            # Floor the retry pacing at 50 ms even when the env pins
            # F16_FAULT_BACKOFF_S=0 (the drills do): instant retries
            # would burn every attempt inside one unroutable instant —
            # a respawn or shed-recovery needs a beat to land.
            delay = max(self.backoff.delay_s(attempt, self._rng), 0.05) \
                if attempt >= 1 else 0.0
            if delay:
                time.sleep(min(delay, 2.0))
            try:
                link = self._dispatch(req, exclude=exclude)
                with self._lock:
                    self.redispatches += 1
                if req.trace:
                    # Failover/retriable re-dispatch on the request's
                    # own trace: the merged render shows the hop.
                    obs.event("fleet", action="redispatch",
                              worker=link.index, rid=req.rid,
                              failover=req.failover,
                              trace_id=req.trace["trace_id"])
            except NoRoutableWorker:
                if attempt + 1 >= self.max_attempts:
                    req._fail(NoRoutableWorker(
                        f"no routable worker after {attempt + 1} "
                        f"attempts (request {req.rid})"))
                    self._note_recovered(req)
                else:
                    self._repair_q.put((req, attempt + 1, exclude))

    # -- dispatch --------------------------------------------------------

    def _routable_links(self, exclude=()):
        now = time.monotonic()
        return [l for l in self.links
                if l.index not in exclude and l.routable(self.stall_s, now)]

    def _pick(self, exclude=()):
        candidates = self._routable_links(exclude)
        if not candidates and exclude:
            # Better a hedge/retry on an already-tried worker than none.
            candidates = self._routable_links()
        if not candidates:
            raise NoRoutableWorker(
                "no routable fleet worker (all down, stalled, draining, "
                "or shedding)")
        return min(candidates, key=lambda l: l.load())

    def _dispatch(self, req, exclude=()):
        """Send ``req`` to the best routable worker; walks the candidate
        set on send failure. Raises NoRoutableWorker when nobody takes
        it (nothing was dispatched — retriable by contract)."""
        tried = set(exclude)
        msg = {"id": req.rid, "op": "score", "model": req.model_id,
               "kind": req.kind, "x": req.x}
        if req.trace:
            # Cross-process trace context — sampled requests
            # only, so an unsampled frame stays byte-identical to the
            # pre-trace wire. The router's span id is the worker's
            # parent: its serve.request span nests under fleet.request.
            msg["trace_id"] = req.trace["trace_id"]
            msg["parent_id"] = req.trace["span_id"]
        while True:
            link = self._pick(tried)
            try:
                link.send_request(req, msg)
            except OSError:
                tried.add(link.index)
                if len(tried) >= len(self.links) * 2:
                    raise NoRoutableWorker(
                        "every fleet worker refused the dispatch")
                continue
            req.attempts.append(link.index)
            return link

    # -- reader callbacks ------------------------------------------------

    def _on_response(self, link, req, msg):
        ok = bool(msg.get("ok"))
        if ok:
            first = req._complete(msg.get("out"))
        else:
            exc = _rebuild_error(msg)
            if getattr(exc, "retriable", False) and not req.done():
                # The worker never dispatched (drain/shed rejection):
                # re-route — the zero-drop half of rolling restarts.
                self._repair_q.put((req, 0, (link.index,)))
                return
            first = req._fail(exc)
        if first:
            latency_ms = (time.perf_counter() - req.t_submit) * 1000.0
            self.latency.record(latency_ms)
            if self.slo is not None:
                # The merged fleet stream: every first completion from
                # ANY worker, errors included — the burn the rolling
                # restart annotation and `serve --json` report.
                self.slo.observe(latency_ms=latency_ms if ok else None,
                                 error=not ok)
            with self._lock:
                self.completed += 1
            if req.trace:
                # The router's half of the cross-process trace: one
                # fleet.request span per sampled request, on the same
                # trace id the worker's serve.request span adopted.
                obs.event("span", name="fleet.request",
                          wall_s=round(latency_ms / 1000.0, 6),
                          cold=False, trace_id=req.trace["trace_id"],
                          span_id=req.trace["span_id"],
                          model_id=req.model_id, req_kind=req.kind,
                          worker=link.index, ok=ok,
                          attempts=len(req.attempts),
                          failover=req.failover)
            self._note_recovered(req)
        else:
            with self._lock:
                self.hedge_coalesced += 1
            if req.trace:
                # The hedge LOSER, on the same trace as the winner.
                obs.event("fleet", action="hedge-coalesced",
                          worker=link.index, rid=req.rid,
                          trace_id=req.trace["trace_id"])

    def _on_unmatched(self, index, msg):
        """A response whose rid has no pending entry on that link: a
        hedged duplicate another link already answered, or a control
        ack handled synchronously elsewhere."""
        if msg.get("op_ack") or "acct" in msg or "stats" in msg \
                or "worker" in msg:
            return
        with self._lock:
            self.hedge_coalesced += 1

    def _on_link_down(self, link, orphans):
        live = [r for r in orphans if not r.done()]
        with self._lock:
            if live:
                for req in live:
                    req.failover = True
                if self._open_failover is None:
                    self._open_failover = {
                        "worker": link.index,
                        "t_detect": time.monotonic(),
                        "t_recovered": None,
                        "n_orphans": 0,
                        "outstanding": 0,
                    }
                self._open_failover["n_orphans"] += len(live)
                self._open_failover["outstanding"] += len(live)
        obs.event("fleet", action="link-down", worker=link.index,
                  orphans=len(live),
                  trace_ids=[r.trace["trace_id"]
                             for r in live if r.trace])
        for req in live:
            # attempt=1 → one backoff step before the re-dispatch; the
            # dead worker is excluded outright.
            self._repair_q.put((req, 1, (link.index,)))

    def _note_recovered(self, req):
        """Failover bookkeeping: when the last outstanding ORPHAN (not
        just any request) settles, the failover window closes."""
        if not req.failover:
            return
        with self._lock:
            if not req.failover:
                return
            req.failover = False
            fo = self._open_failover
            if fo is None:
                return
            fo["outstanding"] -= 1
            if fo["outstanding"] <= 0:
                fo["t_recovered"] = time.monotonic()
                fo.pop("outstanding")
                self.failovers.append(fo)
                self._open_failover = None

    @property
    def last_failover_s(self):
        with self._lock:
            if not self.failovers:
                return None
            fo = self.failovers[-1]
            return round(fo["t_recovered"] - fo["t_detect"], 4)

    # -- client API (ScoringService duck type) ---------------------------

    def submit(self, model_id, x, kind="predict"):
        with self._lock:
            self._rid += 1
            rid = self._rid
        # The fleet's ONE sampling decision (F16_TRACE_SAMPLE) — minted
        # here, carried on the wire, adopted by every worker the request
        # touches. None (telemetry off / coin lost) costs nothing
        # downstream: no wire fields, no events.
        req = FleetRequest(rid, model_id, x, kind, trace=obs.mint_trace())
        try:
            self._dispatch(req)
        except NoRoutableWorker:
            # Give the repair loop (and the fleet's respawn) a chance
            # before surfacing the rejection.
            self._repair_q.put((req, 1, ()))
        return req

    def score(self, model_id, x, kind="predict", timeout=None):
        """Synchronous submit + hedged wait: after ``hedge_ms`` of
        silence the request is duplicated to another worker (same rid —
        the late response coalesces)."""
        req = self.submit(model_id, x, kind=kind)
        deadline = (time.perf_counter() + timeout) if timeout else None
        hedge_s = self.hedge_ms / 1000.0
        hedge_n = 0
        while True:
            # Hedge pacing through the resilience backoff schedule:
            # hedge k waits the straggler horizon plus the k-th backoff
            # step, so a fleet-wide slowdown doesn't fan out a hedge
            # storm at a fixed cadence.
            wait_s = hedge_s + (self.backoff.delay_s(hedge_n, self._rng)
                                if hedge_n else 0.0)
            if deadline is not None:
                wait_s = min(wait_s, deadline - time.perf_counter())
                if wait_s <= 0:
                    return req.result(0.0)
            if req.wait(wait_s):
                return req.result(0.0)
            if hedge_n + 1 < self.max_attempts:
                hedge_n += 1
                try:
                    link = self._dispatch(req, exclude=tuple(req.attempts))
                    with self._lock:
                        self.hedges += 1
                    if req.trace:
                        # The hedge duplicate, on the request's trace.
                        obs.event("fleet", action="hedge",
                                  worker=link.index, rid=req.rid,
                                  hedge_n=hedge_n,
                                  trace_id=req.trace["trace_id"])
                except NoRoutableWorker:
                    pass  # keep waiting on the original

    def stats(self):
        snap = self.latency.snapshot()
        workers = [l.snapshot() for l in self.links]
        quarantined = sorted({q for w in workers
                              for q in w["hb"].get("quarantined", [])})
        with self._lock:
            counters = {"completed": self.completed,
                        "hedges": self.hedges,
                        "hedge_coalesced": self.hedge_coalesced,
                        "redispatches": self.redispatches,
                        "failovers": len(self.failovers)}
        return {
            "models": sorted({m for w in workers
                              for m in (w["hb"].get("models") or [])}),
            "requests": snap["count"],
            "p50_ms": snap["p50_ms"],
            "p99_ms": snap["p99_ms"],
            "queue_depth": sum(w["hb"].get("queue_depth", 0)
                               for w in workers),
            "quarantined": quarantined,
            "workers": workers,
            "router": counters,
            "rps": self.fleet_rps(),
            "slo": self.slo.summary() if self.slo is not None else None,
        }

    def scrape_worker_stats(self, indices=None, timeout_s=2.0):
        """On-demand worker scrape: a synchronous ``stats``
        round-trip per worker over a SIDE connection, so the routing
        link's pending map and latency accounting never see control
        traffic. Returns {worker index: stats dict}; a worker that is
        down or silent within ``timeout_s`` is simply absent."""
        out = {}
        links = (self.links if indices is None
                 else [self.links[i] for i in indices])
        for link in links:
            try:
                sock = wire.connect_unix(link.socket_path,
                                         timeout=timeout_s)
            except OSError:
                continue
            try:
                sock.settimeout(timeout_s)
                wire.send_msg(sock, {"id": 0, "op": "stats"})
                deadline = time.monotonic() + timeout_s
                while time.monotonic() < deadline:
                    msg = wire.recv_msg(sock)
                    if msg is None:
                        break
                    # Heartbeat pushes arrive on this connection too —
                    # skip them; only the stats response ends the read.
                    if isinstance(msg, dict) and "stats" in msg:
                        out[link.index] = msg["stats"]
                        break
            except (wire.WireError, OSError):
                pass
            finally:
                try:
                    sock.close()
                except OSError:
                    pass
        return out

    # -- rolling restart -------------------------------------------------

    def rolling_restart(self, *, drain_deadline_s=15.0,
                        ready_timeout_s=300.0):
        """Zero-drop rolling restart: walk workers one at a time through
        drain → exit 0 → fleet respawn → reconnect → fresh heartbeat.
        Requires a managed fleet. Returns per-worker step records; the
        chaos drill asserts 0 errors rode along client-side."""
        if self.fleet is None:
            raise ValueError("rolling_restart needs a managed fleet")
        walk_t0 = time.monotonic()
        walk_before = (self.slo.budget_snapshot()
                       if self.slo is not None else None)
        steps = []
        for link in self.links:
            t0 = time.monotonic()
            step_before = (self.slo.budget_snapshot()
                           if self.slo is not None else None)
            handle = self.fleet.workers[link.index]
            old_pid = handle.pid
            with link._lock:
                link.draining = True
            obs.event("fleet", action="rolling-drain", worker=link.index,
                      pid=old_pid)
            # The drain op must actually land: the link may be down
            # (e.g. this worker restarted earlier and the maintenance
            # loop hasn't reconnected yet) — reconnect and retry, and
            # re-pin draining after every connect() (connect resets it).
            deadline = time.monotonic() + ready_timeout_s
            sent = False
            while not sent and handle.alive() \
                    and time.monotonic() < deadline:
                try:
                    link.send_control({"id": 0, "op": "drain",
                                       "deadline_s": drain_deadline_s})
                    sent = True
                except OSError:
                    try:
                        link.close()
                        link.connect()
                        with link._lock:
                            link.draining = True
                    except OSError:
                        time.sleep(0.1)
            # The worker drains, acks (consumed as an unmatched control
            # response), exits 0; the fleet monitor respawns it.
            while handle.pid == old_pid or not handle.alive():
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"worker {link.index} not respawned within "
                        f"{ready_timeout_s}s")
                time.sleep(0.1)
            self.fleet.wait_ready(
                [link.index],
                timeout_s=max(1.0, deadline - time.monotonic()))
            # Reconnect eagerly (the maintenance loop would too) and
            # wait for a fresh heartbeat before moving to the next
            # worker — "one at a time" means never two un-warm workers.
            link.close()
            try:
                link.connect()
            except OSError:
                pass
            while True:
                with link._lock:
                    if link.up and link.hb:
                        break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"worker {link.index} respawned but no "
                        f"heartbeat within {ready_timeout_s}s")
                time.sleep(0.05)
            step = {"worker": link.index, "old_pid": old_pid,
                    "new_pid": handle.pid,
                    "wall_s": round(time.monotonic() - t0, 3)}
            if step_before is not None:
                # What this worker's drain window cost the fleet error
                # budget — the restart's operability price.
                step["budget"] = _slo.budget_spend(
                    step_before, self.slo.budget_snapshot(),
                    self.slo.config)
            steps.append(step)
            obs.event("fleet", action="rolling-done", worker=link.index,
                      new_pid=handle.pid,
                      wall_s=step["wall_s"],
                      budget_burn=step.get("budget", {}).get("burn"))
        result = {"workers": len(steps), "steps": steps,
                  "wall_s": round(time.monotonic() - walk_t0, 3)}
        if walk_before is not None:
            result["budget"] = _slo.budget_spend(
                walk_before, self.slo.budget_snapshot(), self.slo.config)
        return result
