"""The ``serve`` CLI verb: stand the scoring service up, drive it with a
closed-loop client load, print one JSON stats line.

    python -m flake16_framework_tpu_torch serve [--synth N] [--trees T]
        [--max-depth D] [--ledger scores.pkl] [--limit K]
        [--requests N] [--rows R] [--clients C]
        [--kinds predict,shap] [--buckets 8,32,128]
        [--registry DIR] [--json]
        [--hold] [--hold-timeout S] [--drain-deadline S]
        [--metrics-port N] [--slo] [--slo-p99-ms MS]
        [--fleet W] [--workdir DIR] [--rolling-restart]
        [--worker --socket PATH [--device D]]

Without ``--ledger`` it fits + registers the study's two SHAP configs
(config.SHAP_CONFIGS) on synthetic data; with it, every config the
sweep's scores ledger holds (canonical grid order, ``--limit`` bounds
the count). ``--registry DIR`` persists the artifacts (register ->
reload round-trips). The service runs on ``cuda`` unless ``serve_main``
is given another ``device``.

``--hold`` is the drain drill's child half: serve a closed-loop load
until SIGTERM (or ``--hold-timeout``), then ``ScoringService.drain`` and
print one ``DRAIN_ACCT {json}`` line. Exit 0 iff the drain completed
within the deadline and every client request was accounted for
(completed, or retriably rejected) — zero silent drops.

``--slo`` arms the SLO monitor: declared objectives (``--slo-p99-ms``)
evaluated as multi-window burn rates that shed load at admission on a
breach (obs/slo.py). ``--metrics-port N`` stands the Prometheus exporter
up beside the service (``obs/metrics.py``; 0 = an ephemeral port) and
prints ``METRICS_PORT <port>``; the SLO loop rides along with it. Without
``--buckets`` the service warms the performance database's recorded
ladder, else ``service.DEFAULT_BUCKETS`` (``service.resolve_buckets``).

``--fleet W`` fits + persists the registry (under ``--workdir`` when no
``--registry`` is given), spawns W worker processes over it
(serve/fleet.Fleet, each on ``cuda`` unless ``serve_main`` is given
another ``device``), stands the health-gated hedging router up
(serve/router.FleetRouter) and drives the same ``sustained_load``
through the router; ``--slo`` then declares the fleet's objectives (the
router's monitor accounts and deprioritizes, the workers' shed). With
``--rolling-restart`` the load is followed by a zero-drop rolling restart
walk. ``--worker --socket PATH --registry DIR`` is the child half the
fleet spawns: load the persisted registry (no fitting), warm, answer
wire-protocol frames until drained; ``--device`` (a worker's only) is
where it runs. With ``--fleet W``, ``--metrics-port`` stands ONE
federated exporter up beside the router (``register_fleet_sources``:
per-worker series labelled ``worker="<i>"`` plus fleet aggregates);
workers never open their own.
"""

import json
import sys
import threading
import time


def sustained_load(service, feats, model_ids, *, n_requests=256, rows=16,
                   kinds=("predict",), clients=8, timeout=120.0):
    """Closed-loop client load: ``clients`` threads, each scoring its
    share of ``n_requests`` synchronously (round-robin over models and
    kinds, sliding row windows over ``feats``). Returns the measured
    stats dict: requests, wall_s, rps, p50/p99, errors."""
    n_clients = max(1, min(int(clients), int(n_requests)))
    per = int(n_requests) // n_clients
    errors = []
    lock = threading.Lock()

    def client(ci):
        for i in range(per):
            j = ci * per + i
            model_id = model_ids[j % len(model_ids)]
            kind = kinds[j % len(kinds)]
            off = (j * rows) % max(1, feats.shape[0] - rows)
            try:
                service.score(model_id, feats[off:off + rows], kind=kind,
                              timeout=timeout)
            except Exception as e:
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    total = per * n_clients
    snap = service.latency.snapshot()
    svc = service.stats()
    return {
        "requests": total,
        "completed": snap["count"],
        "clients": n_clients,
        "rows": rows,
        "kinds": list(kinds),
        "wall_s": round(wall, 4),
        "rps": round(total / wall, 2) if wall > 0 else None,
        "p50_ms": snap["p50_ms"],
        "p99_ms": snap["p99_ms"],
        "queue_depth": svc["queue_depth"],
        "quarantined": sorted(svc["quarantined"]),
        "errors": errors[:8],
        "n_errors": len(errors),
    }


def hold_until_signal(service, feats, model_ids, *, rows=16,
                      kinds=("predict",), clients=8, hold_timeout=120.0,
                      drain_deadline=10.0):
    """The drain drill's child half: drive a closed-loop load, print
    ``SERVE_READY``, wait for SIGTERM/SIGINT (bounded by
    ``hold_timeout``), then drain. Every client request ends in exactly
    one bucket — ok (future completed), retriable (drain rejection:
    safe to resubmit), rejected (non-retriable admission), failed
    (anything else) — so "zero silently dropped" is checkable from the
    returned counts alone."""
    import signal

    from flake16_framework_tpu_torch.serve.queue import RequestRejected

    stop_evt = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_evt.set())
    signal.signal(signal.SIGINT, lambda *_: stop_evt.set())

    counts = {"ok": 0, "retriable": 0, "rejected": 0, "failed": 0}
    lock = threading.Lock()
    n_clients = max(1, int(clients))

    def client(ci):
        j = ci
        while True:
            model_id = model_ids[j % len(model_ids)]
            kind = kinds[j % len(kinds)]
            off = (j * rows) % max(1, feats.shape[0] - rows)
            try:
                service.score(model_id, feats[off:off + rows], kind=kind,
                              timeout=60.0)
                k = "ok"
            except Exception as e:
                k = ("retriable" if getattr(e, "retriable", False)
                     else "rejected" if isinstance(e, RequestRejected)
                     else "failed")
            with lock:
                counts[k] += 1
            if k != "ok":
                return

    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(n_clients)]
    for t in threads:
        t.start()
    print("SERVE_READY", flush=True)
    stop_evt.wait(hold_timeout)
    acct = service.drain(deadline_s=drain_deadline)
    for t in threads:
        t.join(10.0)
    return {"drain": acct, "counts": dict(counts),
            "signalled": stop_evt.is_set()}


def _parse(args):
    opts = {
        "synth": 512, "trees": 16, "max_depth": 12, "ledger": None,
        "limit": None, "requests": 256, "rows": 16, "clients": 8,
        # None = consult the performance database for a recorded bucket
        # ladder, falling through to service.DEFAULT_BUCKETS
        # (obs/perfdb.serve_buckets); --buckets pins it explicitly.
        "kinds": ("predict",), "buckets": None,
        "registry": None, "json": False,
        "hold": False, "hold_timeout": 120.0, "drain_deadline": 10.0,
        "metrics_port": None, "slo": False, "slo_p99_ms": 50.0,
        "worker": False, "socket": None, "device": None,
        "fleet": None, "workdir": None, "rolling_restart": False,
    }
    it = iter(args)
    for a in it:
        if a == "--json":
            opts["json"] = True
        elif a == "--hold":
            opts["hold"] = True
        elif a == "--slo":
            opts["slo"] = True
        elif a == "--worker":
            opts["worker"] = True
        elif a == "--rolling-restart":
            opts["rolling_restart"] = True
        elif a in ("--hold-timeout", "--drain-deadline", "--slo-p99-ms"):
            opts[a[2:].replace("-", "_")] = float(next(it))
        elif a in ("--synth", "--trees", "--max-depth", "--limit",
                   "--requests", "--rows", "--clients", "--fleet",
                   "--metrics-port"):
            opts[a[2:].replace("-", "_")] = int(next(it))
        elif a == "--ledger":
            opts["ledger"] = next(it)
        elif a in ("--registry", "--socket", "--workdir", "--device"):
            opts[a[2:]] = next(it)
        elif a == "--kinds":
            opts["kinds"] = tuple(next(it).split(","))
        elif a == "--buckets":
            opts["buckets"] = tuple(int(b) for b in next(it).split(","))
        else:
            raise ValueError(f"Unrecognized serve option {a!r}")
    if opts["device"] is not None and not opts["worker"]:
        raise ValueError("serve --device is a fleet worker's option "
                         "(serve --worker); the serve verb runs on cuda")
    return opts


def _fleet_main(opts, feats, registry, device):
    """The ``--fleet W`` body: spawn the worker fleet over the persisted
    registry on ``device``, route the sustained load through the hedging
    router, then (optionally) walk a zero-drop rolling restart. With
    ``--metrics-port`` the router's federated exporter serves throughout
    and ``METRICS_PORT <port>`` is printed."""
    import os

    from flake16_framework_tpu_torch.obs.slo import SLOConfig
    from flake16_framework_tpu_torch.serve.fleet import Fleet
    from flake16_framework_tpu_torch.serve.router import FleetRouter

    os.makedirs(opts["workdir"], exist_ok=True)
    slo_p99 = opts["slo_p99_ms"] if opts["slo"] else None
    # Without --slo the router still accounts with the defaults.
    fleet_slo = SLOConfig(p99_ms=opts["slo_p99_ms"]) if opts["slo"] else None
    with Fleet(registry.root, opts["fleet"], workdir=opts["workdir"],
               buckets=opts["buckets"], slo_p99_ms=slo_p99,
               device=device) as fleet:
        with FleetRouter(fleet, slo=fleet_slo) as router:
            metrics_srv = None
            if opts["metrics_port"] is not None:
                from flake16_framework_tpu_torch.obs import metrics

                reg = metrics.MetricsRegistry()
                metrics.register_process_sources(reg)
                metrics.register_fleet_sources(reg, router)
                metrics_srv = metrics.MetricsServer(
                    reg, port=opts["metrics_port"]).start()
                print(f"METRICS_PORT {metrics_srv.port}", flush=True)
            try:
                result = sustained_load(
                    router, feats, registry.ids(),
                    n_requests=opts["requests"], rows=opts["rows"],
                    kinds=opts["kinds"], clients=opts["clients"])
                if opts["rolling_restart"]:
                    result["rolling_restart"] = router.rolling_restart(
                        drain_deadline_s=opts["drain_deadline"])
                stats = router.stats()
                result["fleet"] = {
                    "workers": opts["fleet"],
                    "pids": fleet.pids(),
                    "router": stats["router"],
                    "rps": stats["rps"],
                    "slo": stats["slo"],
                    "failover_s": router.last_failover_s,
                    "per_worker": [w["hb"].get("requests")
                                   for w in stats["workers"]],
                    "launches": [w["hb"].get("launches")
                                 for w in stats["workers"]],
                    "ready_s": [h.ready_s for h in fleet.workers],
                }
                if metrics_srv is not None:
                    result["fleet"]["metrics_port"] = metrics_srv.port
            finally:
                if metrics_srv is not None:
                    metrics_srv.stop()
    return result


def serve_main(args, device=None):
    """The verb's body; ``device`` (``cuda`` by default) is where the
    registry fits and the service, or each fleet worker, runs. Returns
    the exit code."""
    opts = _parse(args)

    if opts["worker"]:
        from flake16_framework_tpu_torch.serve.fleet import worker_main

        return worker_main(opts)

    from flake16_framework_tpu_torch import config as cfg
    from flake16_framework_tpu_torch.serve.registry import ModelRegistry
    from flake16_framework_tpu_torch.serve.service import ScoringService
    from flake16_framework_tpu_torch.utils import synth

    feats, labels, _ = synth.make_dataset(n_tests=opts["synth"], seed=7)

    if opts["fleet"]:
        # Workers load artifacts from disk — a fleet NEEDS a persisted
        # registry; default one under the (possibly ephemeral) workdir.
        import os
        import tempfile

        opts["workdir"] = (opts["workdir"]
                           or tempfile.mkdtemp(prefix="f16-fleet-"))
        opts["registry"] = (opts["registry"]
                            or os.path.join(opts["workdir"], "registry"))

    persist = opts["registry"] is not None
    registry = ModelRegistry(opts["registry"] or "serve-registry",
                             device=device)
    overrides = {"Extra Trees": opts["trees"],
                 "Random Forest": opts["trees"]}
    if opts["ledger"]:
        registry.register_from_ledger(
            opts["ledger"], feats, labels, limit=opts["limit"],
            max_depth=opts["max_depth"], tree_overrides=overrides,
            persist=persist)
    else:
        for keys in cfg.SHAP_CONFIGS:
            registry.fit_and_register(
                keys, feats, labels, max_depth=opts["max_depth"],
                tree_overrides=overrides, persist=persist)

    if opts["fleet"]:
        result = _fleet_main(opts, feats, registry, device)
        result["device"] = str(registry.device)
        result["models"] = registry.ids()
        print(json.dumps(result) if opts["json"]
              else json.dumps(result, indent=1))
        sys.stdout.flush()
        return 1 if result["n_errors"] else 0

    slo_cfg = None
    if opts["slo"] or opts["metrics_port"] is not None:
        # The SLO loop rides along whenever the live plane is up: a
        # metrics endpoint without burn rates would expose gauges the
        # admission path ignores.
        from flake16_framework_tpu_torch.obs.slo import SLOConfig

        slo_cfg = SLOConfig(p99_ms=opts["slo_p99_ms"])

    with ScoringService(registry, buckets=opts["buckets"],
                        device=registry.device, slo=slo_cfg,
                        metrics_port=opts["metrics_port"]) as svc:
        if svc.metrics is not None:
            print(f"METRICS_PORT {svc.metrics.port}", flush=True)
        if opts["hold"]:
            result = hold_until_signal(
                svc, feats, registry.ids(), rows=opts["rows"],
                kinds=opts["kinds"], clients=opts["clients"],
                hold_timeout=opts["hold_timeout"],
                drain_deadline=opts["drain_deadline"])
        else:
            result = sustained_load(
                svc, feats, registry.ids(), n_requests=opts["requests"],
                rows=opts["rows"], kinds=opts["kinds"],
                clients=opts["clients"])
        slo_summary = svc.slo_summary()
        if slo_summary is not None:
            result["slo"] = slo_summary

    result["device"] = str(registry.device)
    if registry.device.type == "cuda":
        import torch

        result["device_name"] = torch.cuda.get_device_name(registry.device)
    result["models"] = registry.ids()
    if opts["hold"]:
        print("DRAIN_ACCT " + json.dumps(result), flush=True)
        ok = (result["drain"]["phase"] == "complete"
              and result["counts"]["failed"] == 0
              and result["counts"]["rejected"] == 0)
        return 0 if ok else 1
    print(json.dumps(result) if opts["json"]
          else json.dumps(result, indent=1))
    sys.stdout.flush()
    return 1 if result["n_errors"] else 0
