"""The port's serving fleet (``flake16_framework_tpu_torch.serve.wire``,
``fleet``, ``router``) and the telemetry it stands on (``obs.core``,
``obs.flight``, ``obs.slo``) against the JAX package's, all on the CPU
with tiny models and real worker processes (``device="cpu"``, two
workers a fleet).

Held across the packages: wire frames byte for byte (both ways, trace
fields on and off), flight rings replayed both ways and the same
``.w<i>`` ring paths, the SLO monitors' burn sequences and summaries at
every step, every event the port writes valid under the JAX schema, the
fault plan's worker entries, and the JAX ``FleetRouter`` routed to the
port's workers. The port's fleet answers bitwise as its in-process
service does, and within rtol 1e-5, atol 1e-6 of the JAX service on the
same registry directory. The drills in miniature: a SIGKILL failover and
a rolling restart, an injected kill, a stalled worker gated and hedged,
``NoRoutableWorker`` retriable, and a fleet on the default device, which
without CUDA has workers that exit nonzero and are marked failed, never
respawned onto the CPU.
"""

import json
import os
import signal
import socket
import struct
import threading
import time

import jax
import numpy as np
import pytest

from flake16_framework_tpu.obs import flight as jflight
from flake16_framework_tpu.obs import schema as jschema
from flake16_framework_tpu.obs import slo as jslo
from flake16_framework_tpu.resilience import inject as jinject
from flake16_framework_tpu.resilience import ladder as jladder
from flake16_framework_tpu.serve import wire as jwire
from flake16_framework_tpu.serve.registry import ModelRegistry as JRegistry
from flake16_framework_tpu.serve.router import FleetRouter as JRouter
from flake16_framework_tpu.serve.service import ScoringService as JService
from flake16_framework_tpu_torch import obs
from flake16_framework_tpu_torch.kernels import treeshap_unit
from flake16_framework_tpu_torch.obs import flight, slo
from flake16_framework_tpu_torch.ops import treeshap
from flake16_framework_tpu_torch.resilience import inject
from flake16_framework_tpu_torch.serve import (
    ModelRegistry, RetriableRejection, ScoringService, wire,
)
from flake16_framework_tpu_torch.serve import cli as tcli
from flake16_framework_tpu_torch.serve.fleet import Fleet
from flake16_framework_tpu_torch.serve.router import (
    FleetRouter, NoRoutableWorker,
)
from flake16_framework_tpu_torch.utils.synth import make_dataset

DT_CONFIG = ("NOD", "Flake16", "None", "None", "Decision Tree")
ET_CONFIG = ("NOD", "Flake16", "None", "SMOTE Tomek", "Extra Trees")
TINY = {"Extra Trees": 4, "Random Forest": 4}
MAX_DEPTH = 6
BUCKETS = (4, 16)
# The router's backoff between re-dispatches (the repair loop floors it
# at 50 ms), so failover takes a beat, not seconds.
FAST = {"F16_FAULT_BACKOFF_S": "0"}


@pytest.fixture(autouse=True)
def _jax_x64_off(monkeypatch):
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    monkeypatch.setenv("F16_FAULT_BACKOFF_S", "0")
    monkeypatch.delenv(inject.ENV_VAR, raising=False)
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def data():
    feats, labels, _ = make_dataset(n_tests=160, seed=7)
    return np.asarray(feats), labels


@pytest.fixture(scope="module")
def registry(data, tmp_path_factory):
    """A PERSISTED registry of a Decision Tree and an Extra Trees model —
    what fleet workers load from disk (no fitting in a worker)."""
    feats, labels = data
    reg = ModelRegistry(str(tmp_path_factory.mktemp("fleet-registry")),
                        device="cpu")
    with jax.enable_x64(False):
        for keys in (DT_CONFIG, ET_CONFIG):
            reg.fit_and_register(keys, feats, labels, max_depth=MAX_DEPTH,
                                 tree_overrides=TINY, seed=3, persist=True)
    return reg


def _worker_env(tel_root):
    """The workers' environment: telemetry and the flight ring armed, so
    their events and rings can be held against the JAX package's."""
    env = dict(os.environ, F16_TELEMETRY=tel_root, F16_TRACE_SAMPLE="1",
               F16_FLIGHT=os.path.join(tel_root, "flight.bin"),
               F16_TELEMETRY_HEARTBEAT_S="0")
    env.pop(inject.ENV_VAR, None)
    return env


@pytest.fixture(scope="module")
def fleet_pair(registry, tmp_path_factory):
    tel_root = str(tmp_path_factory.mktemp("fleet-telemetry"))
    work = str(tmp_path_factory.mktemp("fleet-work"))
    with Fleet(registry.root, 2, workdir=work, buckets=BUCKETS,
               env=_worker_env(tel_root), device="cpu") as fleet:
        with FleetRouter(fleet, hedge_ms=300.0, environ=FAST) as router:
            yield fleet, router, tel_root


def _requests(registry, feats):
    """(model, kind, rows) of a fixed request set: every model and kind
    at 1, 4 and 16 rows."""
    return [(mid, kind, feats[off:off + n])
            for mid in registry.ids() for kind in ("predict", "shap")
            for off, n in ((0, 1), (5, 4), (20, 16))]


def _wait_for(cond, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def _run_events(tel_root):
    """{run dir: (manifest, events)} under a telemetry root."""
    out = {}
    for name in sorted(os.listdir(tel_root)):
        run_dir = os.path.join(tel_root, name)
        if not name.startswith("run-"):
            continue
        with open(os.path.join(run_dir, jschema.MANIFEST_FILE)) as fd:
            manifest = json.load(fd)
        with open(os.path.join(run_dir, jschema.EVENTS_FILE)) as fd:
            events = [json.loads(line) for line in fd if line.strip()]
        out[run_dir] = (manifest, events)
    return out


# -- wire ----------------------------------------------------------------


def _messages():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    return [
        {"id": 7, "op": "score", "model": "m", "kind": "shap", "x": x},
        {"id": 8, "op": "score", "model": "m", "kind": "predict", "x": x,
         "trace_id": "a1b2c3d4e5f60718", "parent_id": "0badcafe"},
        {"id": 9, "ok": True, "out": x[:, :2].astype(np.float64)},
        {"id": 10, "ok": False, "error": "draining", "retriable": True,
         "error_type": "RetriableRejection"},
        {"hb": {"ts": 1.5, "worker": 1, "pid": 42, "queue_depth": 0,
                "inflight": np.int64(2), "p50_ms": np.float32(1.25),
                "quarantined": [], "launches": {"treeshap_unit": 3}}},
        {"id": 11, "op": "drain", "deadline_s": 15.0},
    ]


@pytest.mark.parametrize("i", range(len(_messages())),
                         ids=["score", "score-traced", "response", "error",
                              "heartbeat", "drain"])
def test_wire_frames_byte_equal_across_packages(i):
    """The same message packs to the same bytes in both packages, and
    each package unpacks the other's frame to the same message."""
    msg = _messages()[i]
    frame = wire.pack(msg)
    assert frame == jwire.pack(msg)
    assert ("trace_id" in msg) == (b"trace_id" in frame)
    for unpack in (wire.unpack_payload, jwire.unpack_payload):
        back = unpack(frame[4:])
        assert wire.pack(back) == frame and jwire.pack(back) == frame


def test_wire_census_matches_jax():
    assert wire.WIRE_SCHEMA == jwire.WIRE_SCHEMA
    assert wire.WIRE_FIELDS == jwire.WIRE_FIELDS
    assert wire.TRACE_FIELDS == frozenset({"trace_id", "parent_id"})
    assert wire.MAX_FRAME == jwire.MAX_FRAME


@pytest.mark.parametrize("sender,receiver", [(wire, jwire), (jwire, wire)],
                         ids=["torch-to-jax", "jax-to-torch"])
def test_wire_socket_across_packages(sender, receiver):
    a, b = socket.socketpair()
    try:
        msg = _messages()[1]
        sender.send_msg(a, msg)
        got = receiver.recv_msg(b)
        np.testing.assert_array_equal(got["x"], msg["x"])
        assert got["x"].dtype == np.float32
        assert {k: v for k, v in got.items() if k != "x"} == \
            {k: v for k, v in msg.items() if k != "x"}
        a.close()
        assert receiver.recv_msg(b) is None  # clean EOF, not an error
    finally:
        b.close()


def test_wire_torn_frame_raises():
    a, b = socket.socketpair()
    try:
        # A length prefix promising more bytes than ever arrive: EOF
        # mid-frame is a WireError (torn peer), never a silent None.
        a.sendall(struct.pack(">I", 64) + b"half")
        a.close()
        with pytest.raises(wire.WireError):
            wire.recv_msg(b)
    finally:
        b.close()


def test_wire_oversized_frame_rejected():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">I", wire.MAX_FRAME + 1))
        with pytest.raises(wire.WireError):
            wire.recv_msg(b)
    finally:
        a.close()
        b.close()


# -- flight ring ----------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(jflight, flight),
                                           (flight, jflight)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_flight_ring_replays_across_packages(tmp_path, writer, reader):
    """A ring one package writes, wrapped past its capacity, replays in
    the other to the same records and the same head/tail."""
    path = str(tmp_path / "flight.bin")
    rec = writer.FlightRecorder(path, capacity=2048)
    events = [{"kind": "gauge", "ts": 100.0 + i, "run": "r",
               "name": "serve.p99_ms", "value": float(i)}
              for i in range(60)]
    for ev in events:
        rec.record(ev)
    rec.close()
    got, meta = reader.replay(path)
    want, jmeta = writer.replay(path)
    assert got == want and meta == jmeta
    assert not meta["torn"] and meta["head"] > 0  # the ring wrapped
    assert got == events[-len(got):]
    assert reader.last_gauges(got) == {"serve.p99_ms": 59.0}


@pytest.mark.parametrize("env,run_dir", [
    ({}, None),
    ({"F16_FLIGHT": "/r/flight.bin"}, None),
    ({"F16_FLIGHT": "/r/flight.bin", "F16_FLEET_WORKER": "2"}, None),
    ({"F16_FLIGHT": "/r/ring", "F16_FLEET_WORKER": "0"}, None),
    ({"F16_FLIGHT": "1"}, None),
    ({"F16_FLIGHT": "1", "F16_FLEET_WORKER": "3"}, "/runs/run-x"),
], ids=["off", "path", "worker", "no-ext", "run-dir-unresolved",
        "run-dir-worker"])
def test_flight_env_path_matches_jax(env, run_dir):
    got = flight.env_path(environ=env, run_dir=run_dir)
    assert got == jflight.env_path(environ=env, run_dir=run_dir)
    if got is not None:
        assert flight.ring_worker_index(got) == \
            jflight.ring_worker_index(got)


def test_flight_dump_dir_merges_worker_rings(tmp_path):
    for w, ts0 in ((0, 100.0), (1, 100.5)):
        rec = flight.FlightRecorder(str(tmp_path / f"flight.w{w}.bin"))
        for i in range(5):
            rec.record({"kind": "gauge", "ts": ts0 + i,
                        "name": f"w{w}.seq", "value": i})
        rec.close()
    records, meta = flight.replay_dir(str(tmp_path))
    assert meta["n"] == 10 and len(meta["rings"]) == 2
    assert records == jflight.replay_dir(str(tmp_path))[0]
    with open(os.devnull, "w") as sink:
        flight.dump_dir(str(tmp_path), out=sink, flush_manifest=False)
    merged = json.load(open(tmp_path / "flight.merged.dump.json"))
    assert merged["meta"]["n"] == 10
    assert [r["fleet_worker"] for r in merged["records"]] == [0, 1] * 5


# -- SLO monitor ----------------------------------------------------------


def test_slo_burn_sequence_matches_jax():
    """One stream of observe/evaluate calls with given timestamps through
    both monitors: the burns, the shedding state and the summary are
    equal at every step, through a breach and a recovery. (The JAX
    monitor runs with ``degrade=False``, as its ladder is process-wide
    state; the port's default ``degrade=True`` actuates nothing.)"""
    cfg = dict(p99_ms=10.0, fast_window_s=2.0, slow_window_s=6.0,
               min_events=4)
    mine = slo.SLOMonitor(slo.SLOConfig(**cfg))
    ref = jslo.SLOMonitor(jslo.SLOConfig(degrade=False, **cfg))
    rng = np.random.default_rng(5)
    now, seen = 1000.0, set()
    for step in range(300):
        now += float(rng.uniform(0.005, 0.08))
        phase = (step // 60) % 3  # calm, slow, erroring
        lat = float(rng.uniform(1.0, 8.0) if phase == 0
                    else rng.uniform(5.0, 40.0))
        err = bool(phase == 2 and rng.random() < 0.3)
        for m in (mine, ref):
            m.observe(latency_ms=None if err else lat, error=err, now=now)
        if step % 3 == 0:
            got, want = mine.evaluate(now=now), ref.evaluate(now=now)
            assert got == want, step
            seen.add(got["shedding"])
        for name in ("burn_fast", "burn_slow", "shedding"):
            assert getattr(mine, name) == getattr(ref, name), (step, name)
        assert mine.summary(now=now) == ref.summary(now=now), step
        assert mine.budget_snapshot() == ref.budget_snapshot()
    assert seen == {True, False} and mine.breaches >= 1
    assert mine.recoveries >= 1
    before = {"events": 3, "errors": 1, "over_latency": 1}
    after = mine.budget_snapshot()
    assert slo.budget_spend(before, after, mine.config) == \
        jslo.budget_spend(before, after, ref.config)


def test_slo_breach_sheds_and_keeps_the_kernel(registry, data, monkeypatch):
    """A breach sheds admission with a retriable rejection and emits its
    ``slo`` event with ``degraded=False``; SHAP stays on the kernel's
    wrapper (``unit_shap``, whose CPU twin is the plain version) before,
    during and after, with the same values."""
    feats, _ = data
    calls = {"unit_shap": 0, "plain": 0}
    real_unit, real_plain = treeshap.unit_shap, treeshap_unit.unit_shap_plain

    def unit(*args):
        calls["unit_shap"] += 1
        return real_unit(*args)

    def plain(*args):
        calls["plain"] += 1
        return real_plain(*args)

    monkeypatch.setattr(treeshap, "unit_shap", unit)
    monkeypatch.setattr(treeshap_unit, "unit_shap_plain", plain)
    events = []
    monkeypatch.setattr(slo.core, "event",
                        lambda kind, **kw: events.append((kind, kw)))
    mid = registry.ids()[1]
    cfg = slo.SLOConfig(p99_ms=1e-6, min_events=2)  # every request late
    with ScoringService(registry, buckets=BUCKETS, device="cpu",
                        slo=cfg) as svc:
        call = svc.store.call
        first = svc.score(mid, feats[:4], kind="shap", timeout=60)
        svc.score(mid, feats[:4], kind="shap", timeout=60)
        # the dispatcher evaluates just after it completes the request
        _wait_for(lambda: svc.slo.shedding)
        assert svc.slo.breaches == 1
        with pytest.raises(RetriableRejection, match="shedding"):
            svc.submit(mid, feats[:4], kind="shap")
        assert svc.slo.shed_total == 1
        assert events[0][0] == "slo" and events[0][1]["state"] == "breach"
        assert events[0][1]["degraded"] is False
        svc.slo.evaluate(now=time.time() + 60.0)  # the windows empty out
        assert not svc.slo.shedding and svc.slo.recoveries == 1
        again = svc.score(mid, feats[:4], kind="shap", timeout=60)
        assert svc.store.call == call
        summary = svc.slo_summary()
    np.testing.assert_array_equal(again, first)
    # warm (one a model and bucket) and three requests, each through the
    # wrapper
    assert calls["unit_shap"] == len(registry) * len(BUCKETS) + 3
    assert calls["plain"] == calls["unit_shap"]
    assert set(summary) == set(jslo.SLOMonitor().summary())


# -- events ---------------------------------------------------------------


def test_events_validate_against_jax_schema(registry, data, tmp_path,
                                            monkeypatch):
    """Every event the port's core writes with telemetry on — serving
    spans and per-request spans, counters, gauges, drain, slo, flight,
    fleet, heartbeat — passes the JAX package's ``validate_event``, the
    manifest its ``validate_manifest``, and the flight ring mirrors the
    sink."""
    feats, _ = data
    ring = str(tmp_path / "ring.bin")
    monkeypatch.setenv("F16_FLIGHT", ring)
    monkeypatch.setenv("F16_TRACE_SAMPLE", "1")
    run_dir = obs.configure(root=str(tmp_path / "tel"), heartbeat_s=0.05)
    try:
        cfg = slo.SLOConfig(p99_ms=1e-6, min_events=2)
        with ScoringService(registry, buckets=BUCKETS, device="cpu",
                            slo=cfg) as svc:
            for kind in ("predict", "shap"):
                svc.score(registry.ids()[0], feats[:3], kind=kind,
                          timeout=60)
            _wait_for(lambda: svc.slo.shedding)  # the breach's event
            svc.slo.evaluate(now=time.time() + 60.0)  # and the recovery's
            svc.drain(deadline_s=10.0)
        obs.event("fleet", action="restart", worker=0, rc=-9, restarts=1)
        obs.emit_memory_gauges()
        time.sleep(0.2)  # a few heartbeats
    finally:
        obs.shutdown()
    with open(os.path.join(run_dir, jschema.EVENTS_FILE)) as fd:
        events = [json.loads(line) for line in fd]
    kinds = {e["kind"] for e in events}
    assert {"span", "counter", "gauge", "drain", "slo", "flight", "fleet",
            "heartbeat"} <= kinds
    names = {e.get("name") for e in events if e["kind"] == "span"}
    assert {"serve.warm", "serve.dispatch", "serve.request",
            "serve.request.queue"} <= names
    for ev in events:
        assert jschema.validate_event(ev) == [], ev
    with open(os.path.join(run_dir, jschema.MANIFEST_FILE)) as fd:
        manifest = json.load(fd)
    assert jschema.validate_manifest(manifest) == []
    assert manifest["serve_device"] == "cpu" and "gauges" in manifest
    records, meta = jflight.replay(ring)
    assert not meta["torn"] and records == events[-len(records):]


# -- fault plan ------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "0:3:worker-kill;1:2:worker-stall",
    "*:5:worker-kill",
    "1:*:worker-stall;2:5:oom;1:1:sigkill",
])
def test_inject_worker_entries_match_jax(spec):
    plan, ref = inject.parse_plan(spec), jinject.parse_plan(spec)
    assert plan.worker_entries() == ref.worker_entries()
    for w in range(3):
        for n in range(1, 7):
            assert plan.worker_action(w, n) == ref.worker_action(w, n)
    assert plan.check(0, 3) is None  # never through the guard
    assert inject.strip_process_entries(spec) == \
        jinject.strip_process_entries(spec)


# -- the fleet --------------------------------------------------------------


def test_fleet_answers_equal_service_and_jax(fleet_pair, registry, data):
    """The fleet's answers, one request at a time, are bitwise the port's
    in-process service's on the same registry, and within rtol 1e-5,
    atol 1e-6 of the JAX package's service on the same directory."""
    _, router, _ = fleet_pair
    feats, _ = data
    reqs = _requests(registry, feats)
    got = [router.score(mid, x, kind=kind, timeout=60)
           for mid, kind, x in reqs]
    with ScoringService(registry, buckets=BUCKETS, device="cpu") as svc:
        want = [svc.score(mid, x, kind=kind, timeout=60)
                for mid, kind, x in reqs]
    jladder.reset()
    try:
        jreg = JRegistry(registry.root)
        assert [m.model_id for m in jreg.load()] == registry.ids()
        with JService(jreg, buckets=BUCKETS) as jsvc:
            ref = [np.asarray(jsvc.score(mid, x, kind=kind, timeout=120))
                   for mid, kind, x in reqs]
    finally:
        jladder.reset()
    for (mid, kind, x), a, b, c in zip(reqs, got, want, ref):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), (mid, kind, x.shape)
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)


def test_jax_router_routes_to_port_workers(fleet_pair, registry, data):
    """The JAX package's ``FleetRouter`` over the port's worker sockets:
    the same wire and ops, so the same answers, bitwise."""
    fleet, router, _ = fleet_pair
    feats, _ = data
    reqs = _requests(registry, feats)
    want = [router.score(mid, x, kind=kind, timeout=60)
            for mid, kind, x in reqs]
    with JRouter(socket_paths=fleet.socket_paths(), hedge_ms=300.0) as jr:
        got = [jr.score(mid, x, kind=kind, timeout=60)
               for mid, kind, x in reqs]
        assert jr.stats()["router"]["completed"] == len(reqs)
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()


def test_fleet_stats_and_heartbeats(fleet_pair, registry, data):
    """``stats`` (over a side connection) and the heartbeats carry each
    worker's pid, device and kernel launch counts; the router's stats
    sum the fleet."""
    fleet, router, _ = fleet_pair
    feats, _ = data
    for kind in ("predict", "shap"):
        router.score(registry.ids()[0], feats[:4], kind=kind, timeout=60)
    scraped = router.scrape_worker_stats()
    assert sorted(scraped) == [0, 1]
    for i, st in scraped.items():
        assert st["pid"] == fleet.pids()[i] and st["device"] == "cpu"
        assert st["models"] == registry.ids()
        # a CPU worker takes the plain version, which counts no launch
        assert st["launches"] == {"treeshap_unit": 0, "hist_cumsum": 0}
        assert "max_memory_allocated_mb" not in st
    time.sleep(0.6)
    stats = router.stats()
    assert len(stats["workers"]) == 2 and stats["models"] == registry.ids()
    for w in stats["workers"]:
        assert w["up"] and w["hb"]["launches"]["treeshap_unit"] == 0
    assert stats["router"]["completed"] >= 2
    assert all(len(h.ready_s) >= 1 and h.ready_s[0] > 0
               for h in fleet.workers)


def test_fleet_trace_adopted_by_workers(fleet_pair, registry, data,
                                        tmp_path, monkeypatch):
    """Sampled requests carry the router's trace across the wire: each
    worker ``serve.request`` span adopts the router's trace id with the
    router's ``fleet.request`` span as its parent, and every worker event
    passes the JAX schema."""
    _, router, tel_root = fleet_pair
    feats, _ = data
    monkeypatch.setenv("F16_TRACE_SAMPLE", "1")
    run_dir = obs.configure(root=str(tmp_path / "router"), heartbeat_s=0)
    try:
        for i in range(4):
            router.score(registry.ids()[0], feats[i:i + 4], timeout=60)
    finally:
        obs.shutdown()
    with open(os.path.join(run_dir, jschema.EVENTS_FILE)) as fd:
        spans = [e for e in map(json.loads, fd)
                 if e.get("name") == "fleet.request"]
    assert len(spans) == 4
    parent = {e["trace_id"]: e["span_id"] for e in spans}
    adopted = {}
    workers = set()
    for manifest, events in _run_events(tel_root).values():
        assert jschema.validate_manifest(manifest) == []
        workers.add(manifest.get("fleet_worker"))
        for ev in events:
            assert jschema.validate_event(ev) == [], ev
            if ev.get("name") == "serve.request" \
                    and ev.get("trace_id") in parent:
                adopted[ev["trace_id"]] = ev["parent_id"]
    assert adopted == parent
    assert {0, 1} <= workers


def test_fleet_kill_failover_and_rolling_restart(fleet_pair, registry,
                                                 data):
    """SIGKILL worker 0 mid-sequence: every request still completes
    (orphans fail over through the repair queue), the failover window
    closes, the manager dumps the corpse's flight ring and respawns on
    budget — then a rolling restart cycles both workers with zero errors
    and all-new pids."""
    fleet, router, _ = fleet_pair
    feats, _ = data
    mid = registry.ids()[1]
    victim = fleet.workers[0]
    old_pid = victim.pid
    reqs = [router.submit(mid, feats[i:i + 4], kind="shap")
            for i in range(12)]
    os.kill(old_pid, signal.SIGKILL)
    reqs += [router.submit(mid, feats[i:i + 4], kind="shap")
             for i in range(12)]
    for r in reqs:
        assert r.result(timeout=60).shape == (4, 16)
    assert router.last_failover_s is None or router.last_failover_s < 30
    _wait_for(lambda: victim.pid != old_pid and victim.alive(), 120)
    assert victim.restarts == 1 and not victim.failed
    fleet.wait_ready([0], timeout_s=120)
    assert len(victim.ready_s) == 2  # the spawn and the respawn
    assert os.path.exists(fleet.flight_ring_path(victim) + ".dump.json")

    pids_before = fleet.pids()
    errors = []
    stop = threading.Event()

    def load():
        i = 0
        while not stop.is_set():
            try:
                router.score(mid, feats[i % 40:i % 40 + 4],
                             kind=("predict", "shap")[i % 2], timeout=60)
            except Exception as e:  # every error is a failure here
                errors.append(repr(e))
            i += 1

    clients = [threading.Thread(target=load) for _ in range(2)]
    for t in clients:
        t.start()
    try:
        rolling = router.rolling_restart(drain_deadline_s=15,
                                         ready_timeout_s=120)
    finally:
        stop.set()
        for t in clients:
            t.join(60)
    assert not any(t.is_alive() for t in clients)
    assert errors == []
    assert len(rolling["steps"]) == 2
    assert not (set(fleet.pids()) & set(pids_before))
    assert all(h.restarts == r for h, r in zip(fleet.workers, (1, 0)))
    for i in range(4):
        router.score(mid, feats[i:i + 4], timeout=60)


def test_fleet_injected_worker_kill(registry, tmp_path, data):
    """``1:2:worker-kill``: worker 1 SIGKILLs itself as its second score
    request arrives, with requests in flight. Every request completes
    through failover, the manager respawns it on budget, and the
    respawned worker's environment has the plan stripped."""
    feats, _ = data
    env = dict(os.environ)
    env[inject.ENV_VAR] = "1:2:worker-kill"
    mid = registry.ids()[1]
    with Fleet(registry.root, 2, workdir=str(tmp_path), buckets=BUCKETS,
               env=env, device="cpu") as fleet:
        with FleetRouter(fleet, hedge_ms=300.0, environ=FAST) as router:
            reqs = [router.submit(mid, feats[i:i + 4], kind="shap")
                    for i in range(8)]
            for r in reqs:
                assert r.result(timeout=60).shape == (4, 16)
            assert router.last_failover_s is not None
            _wait_for(lambda: fleet.workers[1].restarts >= 1)
            assert fleet.workers[1].restarts == 1
            assert fleet.workers[0].restarts == 0
            assert inject.ENV_VAR not in fleet.workers[1].env
            fleet.wait_ready([1], timeout_s=120)
            assert router.score(mid, feats[:4], timeout=60).shape == (4, 2)


def test_fleet_worker_stall_gated_and_hedged(registry, tmp_path, data):
    """``0:1:worker-stall``: worker 0 swallows its first score request
    and stops heartbeating. The router's hedge covers the swallowed
    request on worker 1 and the staleness gate routes around the stalled
    worker — the client sees answers, never a hang."""
    feats, _ = data
    env = dict(os.environ)
    env[inject.ENV_VAR] = "0:1:worker-stall"
    mid = registry.ids()[0]
    with Fleet(registry.root, 2, workdir=str(tmp_path), buckets=BUCKETS,
               env=env, device="cpu") as fleet:
        with FleetRouter(fleet, hedge_ms=150.0, stall_s=1.0,
                         environ=FAST) as router:
            for i in range(6):
                out = router.score(mid, feats[i:i + 4], timeout=60)
                assert out.shape == (4, 2)
            time.sleep(1.5)  # the stalled worker's heartbeat goes stale
            assert not router.links[0].routable(1.0)
            assert router.stats()["router"]["hedges"] >= 1


def test_no_routable_worker_is_retriable(tmp_path):
    """A router with only dead sockets fails fast with the RETRIABLE
    rejection — a client may resubmit, nothing was dispatched."""
    router = FleetRouter(socket_paths=[str(tmp_path / "w0.sock")],
                         max_attempts=1)
    router.start()
    try:
        req = router.submit("m", np.zeros((1, 4)))
        with pytest.raises(NoRoutableWorker) as ei:
            req.result(timeout=30)
        assert ei.value.retriable
    finally:
        router.stop()


def test_fleet_router_slo_is_observe_only(tmp_path):
    """The fleet monitor measures and deprioritizes, never sheds:
    ``degrade`` is forced off whatever config arrives, and ``slo=False``
    disarms it entirely."""
    sock = str(tmp_path / "w0.sock")
    router = FleetRouter(socket_paths=[sock])
    assert router.slo is not None and router.slo.config.degrade is False
    assert FleetRouter(socket_paths=[sock], slo=False).slo is None
    custom = FleetRouter(socket_paths=[sock],
                         slo=slo.SLOConfig(p99_ms=75.0, degrade=True))
    assert custom.slo.config.p99_ms == 75.0
    assert custom.slo.config.degrade is False


def test_fleet_default_device_fails_without_cuda(registry, tmp_path):
    """No hidden CPU path: a fleet on the default device spawns workers
    that need CUDA; without it each exits nonzero, is marked failed and
    is not respawned."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fleet = Fleet(registry.root, 2, workdir=str(tmp_path),
                  buckets=BUCKETS, ready_timeout_s=120)
    assert fleet.build_kernels() is None  # nothing to build without a card
    try:
        with pytest.raises(RuntimeError, match="failed before ready"):
            fleet.start()
        _wait_for(lambda: all(h.failed for h in fleet.workers))
        time.sleep(0.3)
        for h in fleet.workers:
            assert h.failed and h.spawned == 1 and h.restarts == 0
            assert h.proc.returncode not in (0, None)
            with open(h.log_path) as fd:
                assert "CUDA is not available" in fd.read()
    finally:
        fleet.stop()


# -- the command line -------------------------------------------------------


def test_serve_cli_fleet_with_rolling_restart(tmp_path, capsys):
    code = tcli.serve_main(
        ["--fleet", "2", "--rolling-restart", "--workdir", str(tmp_path),
         "--synth", "120", "--trees", "2", "--max-depth", "4",
         "--requests", "8", "--rows", "4", "--clients", "2", "--buckets",
         "4,8", "--kinds", "predict,shap", "--json",
         # an objective no CPU run misses: the workers never shed here
         "--slo", "--slo-p99-ms", "60000"],
        device="cpu")
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and stats["n_errors"] == 0 and stats["requests"] == 8
    fl = stats["fleet"]
    assert fl["workers"] == 2 and len(fl["pids"]) == 2
    assert fl["slo"]["objective_p99_ms"] == 60000.0
    assert len(fl["per_worker"]) == 2 and len(fl["ready_s"]) == 2
    steps = stats["rolling_restart"]["steps"]
    assert [s["worker"] for s in steps] == [0, 1]
    assert all(s["new_pid"] != s["old_pid"] for s in steps)
    assert (tmp_path / "registry" / "registry.json").exists()
    assert stats["device"] == "cpu" and len(stats["models"]) == 2


@pytest.mark.parametrize("args,key,value", [
    (["--fleet", "3"], "fleet", 3),
    (["--workdir", "/w"], "workdir", "/w"),
    (["--rolling-restart"], "rolling_restart", True),
    (["--worker"], "worker", True),
    (["--worker", "--socket", "/s"], "socket", "/s"),
    (["--worker", "--device", "cpu"], "device", "cpu"),
    (["--slo"], "slo", True),
    (["--slo-p99-ms", "75"], "slo_p99_ms", 75.0),
])
def test_serve_cli_parses_fleet_and_slo_flags(args, key, value):
    assert tcli._parse(args)[key] == value


def test_serve_cli_device_is_a_workers_flag():
    with pytest.raises(ValueError, match="fleet worker's option"):
        tcli._parse(["--device", "cpu"])
