"""Live metrics plane: pull-based registry + Prometheus-text exporter (a
copy of the JAX package's ``obs/metrics.py``; series keep its names,
help texts and kinds).

Everything the JSONL sink records is post-hoc; this module is the LIVE
complement — the same signals (queue depth, latency quantiles, memory
peaks, journal lag, counter totals) readable while the process runs, in
the Prometheus text exposition format, from a stdlib-HTTP thread.
Pull-based on purpose: sources are zero-cost closures sampled only when
a scraper actually asks, so an unscraped (or unserved) registry costs
nothing on the hot path — the same contract as ``F16_TELEMETRY``.

Wiring: ``serve --metrics-port N`` stands a ``MetricsServer`` up beside
the scoring service (port 0 = ephemeral); ``register_process_sources``
contributes the process-wide metrics and ``ScoringService`` registers
its own serve/SLO sources on start. With ``--fleet W`` the router's one
endpoint federates the workers (``register_fleet_sources``). The
exporter reads collaborator modules via ``sys.modules`` only — metrics
must never be the thing that initializes CUDA or imports the sweep.

The dispatch census and the compile-cache series keep the JAX
package's names, so that one dashboard reads both packages' workers:
``f16_aot_dispatches_total`` and ``f16_aot_compiles_total`` count the
instrumented entry points' calls and the serving store's graph
dispatches, and the graph captures and counting passes
(``obs/aot.dispatch_stats``); ``f16_jax_cache_hits_total`` and
``f16_jax_cache_misses_total`` count the kernel build cache
(``obs/aot.cache_stats``). The JAX package's ladder series
(``f16_ladder_halvings``, ``f16_ladder_cpu_fallback``,
``f16_ladder_pallas_broken``) are not exposed: the port leaves the
degradation ladder out on purpose (ROADMAP.md §A).

``METRIC_CENSUS`` is a contract: every ``obs.gauge``/``obs.counter_add``
literal name emitted anywhere in the package is declared here, and the
census holds no other name, so a metric cannot exist in the event
stream while being invisible to the exporter's census
(tests/test_torch_metrics.py scans the package for it).
"""

import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from flake16_framework_tpu_torch.obs import core

# Every gauge/counter NAME the package emits through obs.gauge /
# obs.counter_add (held both ways by the package scan in the tests).
METRIC_CENSUS = frozenset({
    # serve/batcher.py + serve/service.py
    "serve.requests", "serve.queue_depth", "serve.p50_ms", "serve.p99_ms",
    "serve.inflight", "serve.shed",
    # serve/router.py fleet aggregates (the maintenance tick)
    "fleet.rps", "fleet.queue_depth", "fleet.inflight", "fleet.workers_up",
    # obs/core.py memory gauges
    "host_rss_peak_mb", "device_mem_peak_mb",
    # parallel/sweep.py grid totals
    "configs", "folds", "trees",
    # pipeline.py SHAP grid totals
    "shap_configs",
})

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _format_value(value):
    value = float(value)
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _escape_label(value):
    return str(value).replace("\\", r"\\").replace('"', r"\"") \
        .replace("\n", r"\n")


class MetricsRegistry:
    """Named pull sources. ``register(name, fn)`` takes a zero-arg
    closure returning a number (one sample), a dict (fan-out to
    ``name{name="key"}`` labeled samples — ``label=`` picks the label
    key, e.g. ``worker`` for the federated fleet sources), or None
    (source currently absent — e.g. device memory on CPU — and skipped,
    never 0-faked)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources = {}  # name -> (kind, help text, fn, label key)

    def register(self, name, fn, kind="gauge", help="", label="name"):
        with self._lock:
            self._sources[name] = (kind, help, fn, str(label))

    def unregister(self, name):
        with self._lock:
            self._sources.pop(name, None)

    def names(self):
        with self._lock:
            return sorted(self._sources)

    def collect(self):
        """[(name, kind, help, [(labels or None, value), ...])] for every
        source that currently yields a value; a raising or None source is
        skipped (the exporter must survive any collaborator's state)."""
        with self._lock:
            items = sorted(self._sources.items())
        out = []
        for name, (kind, help_text, fn, label_key) in items:
            try:
                value = fn()
            except Exception:
                continue
            if value is None:
                continue
            if isinstance(value, dict):
                samples = [({label_key: str(k)}, float(v))
                           for k, v in sorted(value.items())
                           if isinstance(v, (int, float))]
                if not samples:
                    continue
            else:
                try:
                    samples = [(None, float(value))]
                except (TypeError, ValueError):
                    continue
            out.append((name, kind, help_text, samples))
        return out

    def render(self):
        """The Prometheus text exposition body (format 0.0.4)."""
        lines = []
        for name, kind, help_text, samples in self.collect():
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in samples:
                label_s = ""
                if labels:
                    label_s = "{" + ",".join(
                        f'{k}="{_escape_label(v)}"'
                        for k, v in sorted(labels.items())) + "}"
                lines.append(f"{name}{label_s} {_format_value(value)}")
        return "\n".join(lines) + "\n"


def register_process_sources(registry):
    """Contribute the process-wide sources every exporter shares: uptime,
    memory peaks, journal fold lag, and the telemetry counter totals.
    All read collaborators via ``sys.modules``/getattr — never
    initialize. (The JAX package's ladder series have no source here;
    see the module docstring.)"""
    registry.register(
        "f16_uptime_seconds", _run_uptime_s,
        help="Wall seconds since the telemetry run started (or None "
             "with telemetry off).")
    registry.register(
        "f16_host_rss_peak_mb", core.host_rss_peak_mb,
        help="Peak resident set size of this process, MiB.")
    registry.register(
        "f16_device_mem_peak_mb", core.device_memory_peak_mb,
        help="Peak device memory over local devices, MB (absent where "
             "the backend does not report it).")
    registry.register(
        "f16_aot_dispatches_total", lambda: _aot_stat("dispatches"),
        kind="counter",
        help="Instrumented entry-point calls and executable-store graph "
             "dispatches since process start.")
    registry.register(
        "f16_aot_compiles_total", lambda: _aot_stat("compiles"),
        kind="counter",
        help="Executable-store graph captures and cost-counting passes "
             "since process start.")
    registry.register(
        "f16_jax_cache_hits_total", lambda: _aot_cache_stat("hits"),
        kind="counter",
        help="Kernel build-cache hits (a library already built under its "
             "source hash).")
    registry.register(
        "f16_jax_cache_misses_total", lambda: _aot_cache_stat("misses"),
        kind="counter",
        help="Kernel build-cache misses (an nvcc run).")
    registry.register(
        "f16_journal_fold_lag_seconds", _journal_fold_lag,
        help="Seconds since the last sweep-journal append in this "
             "process (absent before any append).")
    registry.register(
        "f16_events_total", _counter_totals, kind="counter",
        help="Telemetry counter totals by name (the obs.counter_add "
             "census, labeled).")
    return registry


def register_fleet_sources(registry, router, *, scrape_timeout_s=0.5):
    """Federated fleet sources: ONE endpoint for the whole fleet. Per-worker series are labeled ``worker="<i>"`` and
    come from the heartbeat snapshot each routing link already carries,
    backfilled by an on-demand ``stats`` scrape (a side connection, see
    router.scrape_worker_stats) for an up worker whose heartbeat has
    gone stale; fleet aggregates come from the router's own accounting
    (latency ring, rps window, SLO monitor, failover records). The
    per-worker view is sampled once per scrape pass — a 250 ms TTL
    cache shared by every source below — so one GET costs at most one
    heartbeat sweep plus one scrape round per stale worker."""
    import time as _time

    cache = {"t": -1e9, "view": {}}
    cache_lock = threading.Lock()

    def _view():
        with cache_lock:
            now = _time.monotonic()
            if now - cache["t"] >= 0.25:
                view = {}
                stale = []
                for link in router.links:
                    snap = link.snapshot()
                    hb = dict(snap["hb"])
                    if snap["up"] and (not hb or snap["hb_age_s"]
                                       > router.stall_s):
                        stale.append(link.index)
                    view[link.index] = {"up": snap["up"],
                                        "pending": snap["pending"],
                                        "hb": hb}
                if stale:
                    scraped = router.scrape_worker_stats(
                        indices=stale, timeout_s=scrape_timeout_s)
                    for idx, stats in scraped.items():
                        hb = view[idx]["hb"]
                        for field in ("queue_depth", "requests",
                                      "p50_ms", "p99_ms"):
                            if stats.get(field) is not None:
                                hb[field] = stats[field]
                        hb["quarantined"] = sorted(
                            stats.get("quarantined") or ())
                cache["view"] = view
                cache["t"] = now
            return cache["view"]

    def per_worker(field):
        def sample():
            out = {}
            for idx, w in _view().items():
                v = w["hb"].get(field)
                if isinstance(v, bool):
                    out[str(idx)] = int(v)
                elif isinstance(v, (int, float)):
                    out[str(idx)] = v
            return out or None
        return sample

    registry.register(
        "f16_fleet_worker_up",
        lambda: {str(i): int(w["up"]) for i, w in _view().items()},
        label="worker",
        help="1 while the router's link to this worker is up.")
    registry.register(
        "f16_fleet_worker_pending",
        lambda: {str(i): w["pending"] for i, w in _view().items()},
        label="worker",
        help="Requests pending on this worker's link, router side.")
    registry.register(
        "f16_fleet_worker_queue_depth", per_worker("queue_depth"),
        label="worker",
        help="Worker-reported request queue depth (heartbeat/scrape).")
    registry.register(
        "f16_fleet_worker_inflight", per_worker("inflight"),
        label="worker",
        help="Worker-reported microbatches inside a dispatch.")
    registry.register(
        "f16_fleet_worker_requests_total", per_worker("requests"),
        kind="counter", label="worker",
        help="Requests completed by this worker since its start.")
    registry.register(
        "f16_fleet_worker_p50_ms", per_worker("p50_ms"), label="worker",
        help="Worker-local p50 request latency, ms.")
    registry.register(
        "f16_fleet_worker_p99_ms", per_worker("p99_ms"), label="worker",
        help="Worker-local p99 request latency, ms.")
    registry.register(
        "f16_fleet_worker_burn_fast", per_worker("burn_fast"),
        label="worker",
        help="Worker-local SLO fast-window burn (absent without a "
             "worker SLO monitor).")
    registry.register(
        "f16_fleet_worker_shedding", per_worker("shedding"),
        label="worker",
        help="1 while this worker's own SLO monitor is shedding.")

    registry.register(
        "f16_fleet_workers_up",
        lambda: sum(1 for w in _view().values() if w["up"]),
        help="Worker links currently up.")
    registry.register(
        "f16_fleet_rps", router.fleet_rps,
        help="Fleet-wide completed requests per second (router's "
             "sliding window).")
    registry.register(
        "f16_fleet_queue_depth",
        lambda: sum(w["hb"].get("queue_depth", 0)
                    for w in _view().values()),
        help="Sum of worker-reported queue depths.")
    registry.register(
        "f16_fleet_inflight",
        lambda: sum(w["hb"].get("inflight", 0)
                    for w in _view().values()),
        help="Sum of worker-reported inflight microbatches.")
    registry.register(
        "f16_fleet_quarantined",
        lambda: len({q for w in _view().values()
                     for q in (w["hb"].get("quarantined") or ())}),
        help="Distinct models quarantined anywhere in the fleet.")
    registry.register(
        "f16_fleet_requests_total",
        lambda: router.latency.snapshot()["count"], kind="counter",
        help="Requests completed through the router.")
    registry.register(
        "f16_fleet_p50_ms",
        lambda: router.latency.snapshot()["p50_ms"],
        help="Router-observed p50 request latency, ms.")
    registry.register(
        "f16_fleet_p99_ms",
        lambda: router.latency.snapshot()["p99_ms"],
        help="Router-observed p99 request latency, ms.")
    registry.register(
        "f16_fleet_hedges_total", lambda: router.hedges, kind="counter",
        help="Hedge duplicates sent.")
    registry.register(
        "f16_fleet_hedge_coalesced_total",
        lambda: router.hedge_coalesced, kind="counter",
        help="Hedge-loser responses coalesced.")
    registry.register(
        "f16_fleet_redispatches_total",
        lambda: router.redispatches, kind="counter",
        help="Failover/retriable re-dispatches.")
    registry.register(
        "f16_fleet_failovers_total",
        lambda: len(router.failovers), kind="counter",
        help="Closed failover windows (link deaths recovered).")
    if router.slo is not None:
        registry.register(
            "f16_fleet_burn_fast", lambda: router.slo.burn_fast,
            help="Fleet SLO burn over the fast window (1.0 = on "
                 "budget).")
        registry.register(
            "f16_fleet_burn_slow", lambda: router.slo.burn_slow,
            help="Fleet SLO burn over the slow window.")
        registry.register(
            "f16_fleet_slo_breaches_total",
            lambda: router.slo.breaches, kind="counter",
            help="Fleet-level burn-rate breaches recorded.")
    return registry


def _run_uptime_s():
    state = core._state
    if state is None:
        return None
    import time

    return round(time.time() - state.t0, 3)


def _aot_stat(field):
    aot = sys.modules.get("flake16_framework_tpu_torch.obs.aot")
    if aot is None:
        return None
    return int(aot.dispatch_stats().get(field, 0))


def _aot_cache_stat(field):
    aot = sys.modules.get("flake16_framework_tpu_torch.obs.aot")
    if aot is None:
        return None
    return int(aot.cache_stats().get(field, 0))


def _journal_fold_lag():
    journal = sys.modules.get(
        "flake16_framework_tpu_torch.resilience.journal")
    if journal is None:
        return None
    return journal.fold_lag_s()


def _counter_totals():
    state = core._state
    if state is None:
        return None
    with core._lock:
        return dict(state.counters) or None


class MetricsServer:
    """The exporter: a ThreadingHTTPServer daemon thread serving
    ``GET /metrics`` off a registry. ``port=0`` binds an ephemeral port
    (a caller reads ``self.port`` after construction); bound to
    loopback by default — exposing a fleet endpoint is the operator's
    explicit ``host=`` decision, not a default."""

    def __init__(self, registry, port=0, host="127.0.0.1"):
        self.registry = registry
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = server.registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass  # scrapes must not spam the serving process's stderr

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="f16-metrics",
            daemon=True)
        self._thread.start()
        core.event("metrics", action="serve", port=self.port,
                   n_metrics=len(self.registry.names()))
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        core.event("metrics", action="stop", port=self.port)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def validate_exposition(text):
    """Problems with a Prometheus text body (empty list = valid) — the
    grammar subset we emit: HELP/TYPE comments, bare and labeled samples
    with finite numeric values. Shared by ``chip_smoke.py`` and the tests
    so the endpoint and the validator cannot drift."""
    import re

    problems = []
    typed = set()
    sample_re = re.compile(
        r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
        r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
        r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*\})?"
        r" -?[0-9.eE+-]+$")
    for i, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4 or parts[3] not in (
                    "gauge", "counter", "histogram", "summary", "untyped"):
                problems.append(f"line {i}: malformed TYPE: {line!r}")
            else:
                typed.add(parts[2])
            continue
        if line.startswith("# HELP "):
            if len(line.split(None, 3)) < 4:
                problems.append(f"line {i}: malformed HELP: {line!r}")
            continue
        if line.startswith("#"):
            continue
        if not sample_re.match(line):
            problems.append(f"line {i}: malformed sample: {line!r}")
            continue
        name = re.split(r"[{ ]", line, maxsplit=1)[0]
        if name not in typed:
            problems.append(
                f"line {i}: sample {name!r} precedes its # TYPE line")
        try:
            float(line.rsplit(" ", 1)[1])
        except ValueError:
            problems.append(f"line {i}: non-numeric value: {line!r}")
    if not typed:
        problems.append("no metrics exposed")
    return problems
