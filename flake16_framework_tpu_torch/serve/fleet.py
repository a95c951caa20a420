"""Serving fleet: N replicated worker processes behind one router (the
JAX package's ``serve/fleet.py`` for this package).

Two halves live here — the WORKER (``worker_main`` + ``WorkerServer``:
a child process running the :class:`ScoringService` against the shared
on-disk model registry, speaking the serve/wire.py frame protocol on an
AF_UNIX socket) and the FLEET MANAGER (``Fleet`` + ``WorkerHandle``: the
parent that spawns workers, watches them, dumps a dead worker's flight
ring, and respawns within a restart budget). The routing brain — health
gating, hedging, failover, rolling restarts — is serve/router.py; the
fleet only keeps processes alive and findable.

Worker lifecycle: spawn ``python -m flake16_framework_tpu_torch serve
--worker --socket P --registry DIR [--device D]`` with
``F16_FLEET_WORKER=<i>`` in the environment (``subprocess.Popen``: fork
and exec, never a fork that keeps running Python — the parent may hold a
CUDA context of its own, which a forked child cannot use). The worker
resolves its device (``cuda`` unless ``--device`` says otherwise; it
raises without CUDA, so the worker exits nonzero), LOADS the persisted
registry (no fitting), prepares and warms its models on the device (one
SHAP kernel launch a model and bucket), listens, prints
``WORKER_READY``. On CUDA the manager builds the kernel libraries once
before its first spawn, so W workers starting together load them and
never run W compilers. Each router connection gets a reader, a bounded
waiter pool, and a heartbeat pusher (``F16_FLEET_HEARTBEAT_S``) that
streams the worker's queue depth, inflight, p50/p99, SLO burn and kernel
launch counts — host counters only, nothing that synchronizes the
device.

Restart policy: a SIGNAL death (rc < 0) counts against ``max_restarts``
and triggers a flight-ring dump + respawn with fault-inject process and
worker entries stripped (an injected kill fires exactly once); a CLEAN
exit (rc == 0, the drain path — rolling restarts end workers this way)
respawns for free; a NONZERO exit marks the worker failed without
respawn (a registry that cannot load, or a device that is not there,
would otherwise crash-loop the budget away).

Chaos hooks: ``F16_FAULT_INJECT=<worker>:<request#>:worker-kill``
SIGKILLs the worker as the Nth score request arrives (requests in
flight — the router-failover drill); ``worker-stall`` freezes it
(heartbeats stop, accepted requests never answer) so health gating and
hedging have a deterministic straggler.
"""

import json
import os
import signal
import socket as _socket
import subprocess
import sys
import threading
import time

import queue as _stdqueue

import torch

from flake16_framework_tpu_torch.serve import wire

# The worker's index within its fleet — set by the fleet manager in
# each child's environment; consulted by fault injection (worker
# entries address it) and by the flight recorder's ring-path
# uniquification (obs/flight.env_path appends ``.w<i>``).
WORKER_ENV = "F16_FLEET_WORKER"

# Heartbeat push interval, seconds (workers stream health in-band).
HEARTBEAT_ENV = "F16_FLEET_HEARTBEAT_S"
DEFAULT_HEARTBEAT_S = 0.25

WORKER_READY = "WORKER_READY"

# The package's kernel libraries, built by the manager before its first
# spawn (a worker launches K2 for SHAP; it never fits, so never K1).
KERNELS = ("treeshap_unit", "hist_cumsum")


def heartbeat_interval(environ=None):
    env = os.environ if environ is None else environ
    raw = env.get(HEARTBEAT_ENV, "")
    try:
        val = float(raw) if raw else DEFAULT_HEARTBEAT_S
    except ValueError:
        val = DEFAULT_HEARTBEAT_S
    return max(0.05, val)


def worker_index(environ=None):
    env = os.environ if environ is None else environ
    try:
        return int(env.get(WORKER_ENV, "") or 0)
    except ValueError:
        return 0


def launch_counts():
    """This process's kernel launch counts, {kernel name: launches} (the
    wrappers' host-side counters)."""
    from flake16_framework_tpu_torch.kernels.hist import cum_hists
    from flake16_framework_tpu_torch.kernels.treeshap_unit import unit_shap

    return {"treeshap_unit": unit_shap.launches,
            "hist_cumsum": cum_hists.launches}


# ---------------------------------------------------------------------
# Worker half
# ---------------------------------------------------------------------


class WorkerServer:
    """One worker's socket front: accept router connections, decode
    frames, run ops against the wrapped :class:`ScoringService`, push
    heartbeats. ``serve_forever`` returns the drain accounting dict
    once a ``drain`` op lands (the worker then exits 0 — the fleet
    manager respawns a fresh process; a worker never un-drains)."""

    def __init__(self, service, socket_path, *, index=None,
                 heartbeat_s=None, environ=None, waiters=8):
        from flake16_framework_tpu_torch.resilience import inject

        self.service = service
        self.socket_path = socket_path
        env = os.environ if environ is None else environ
        self.index = worker_index(env) if index is None else int(index)
        self.heartbeat_s = (heartbeat_interval(env) if heartbeat_s is None
                            else float(heartbeat_s))
        self._waiters = int(waiters)
        self._plan = inject.plan_from_env(env)
        self._score_no = 0
        self._score_lock = threading.Lock()
        self._stalled = threading.Event()
        self._drained = threading.Event()
        # drain accounting crosses threads: written by whichever conn
        # thread receives the drain op, read by serve_forever after
        # ``_drained`` fires.
        self._acct_lock = threading.Lock()
        self._drain_acct = None
        self._listener = None

    # -- chaos (worker fault-inject classes) -----------------------------

    def _inject_check(self):
        """Consult the fault plan before the next score request; deliver
        worker-kill/worker-stall when scheduled. Returns True when the
        request must be swallowed (stall)."""
        if self._plan is None:
            return self._stalled.is_set()
        with self._score_lock:
            self._score_no += 1
            n = self._score_no
        action = self._plan.worker_action(self.index, n)
        if action == "worker-kill":
            # The drill's deterministic crash: requests are in flight
            # (on CUDA, a kernel may be too), the socket closes with them
            # unanswered — the router's failover path owns them now.
            os.kill(os.getpid(), signal.SIGKILL)
        elif action == "worker-stall":
            self._stalled.set()
        return self._stalled.is_set()

    # -- heartbeat and stats ---------------------------------------------

    def _hb_payload(self):
        snap = self.service.latency.snapshot()
        hb = {
            "ts": round(time.time(), 4),
            "worker": self.index,
            "pid": os.getpid(),
            "queue_depth": self.service.requests.depth(),
            "inflight": self.service.batcher.inflight,
            "requests": snap["count"],
            "p50_ms": snap["p50_ms"],
            "p99_ms": snap["p99_ms"],
            "quarantined": sorted(self.service.batcher.quarantined),
            "models": self.service.registry.ids(),
            "shedding": False,
            "launches": launch_counts(),
        }
        if self.service.slo is not None:
            hb["shedding"] = self.service.slo.shedding
            hb["burn_fast"] = round(self.service.slo.burn_fast, 3)
            hb["burn_slow"] = round(self.service.slo.burn_slow, 3)
        return hb

    def _stats(self):
        """The ``stats`` op's reply: the service's stats, the kernel
        launch counts, the device and, on CUDA, the allocator's peak
        (``torch.cuda.max_memory_allocated``, a host-side counter)."""
        stats = self.service.stats()
        stats["quarantined"] = sorted(stats["quarantined"])
        stats["launches"] = launch_counts()
        stats["pid"] = os.getpid()
        device = self.service.device
        stats["device"] = str(device)
        if device.type == "cuda":
            stats["max_memory_allocated_mb"] = (
                torch.cuda.max_memory_allocated(device) / 1e6)
        return stats

    def _hb_loop(self, conn, send_lock, dead):
        while not dead.is_set() and not self._stalled.is_set() \
                and not self._drained.is_set():
            try:
                with send_lock:
                    wire.send_msg(conn, {"hb": self._hb_payload()})
            except OSError:
                return
            dead.wait(self.heartbeat_s)

    # -- per-connection machinery ----------------------------------------

    def _send_error(self, conn, send_lock, rid, exc):
        msg = {"id": rid, "ok": False, "error": str(exc),
               "retriable": bool(getattr(exc, "retriable", False)),
               "error_type": type(exc).__name__}
        with send_lock:
            wire.send_msg(conn, msg)

    def _waiter_loop(self, conn, send_lock, handoff, dead):
        """Block on score futures and ship responses — a bounded pool so
        the reader never blocks on a slow dispatch."""
        while not dead.is_set():
            try:
                rid, fut = handoff.get(timeout=0.1)
            except _stdqueue.Empty:
                continue
            try:
                try:
                    out = fut.result(timeout=120.0)
                except Exception as e:
                    if not self._stalled.is_set():
                        try:
                            self._send_error(conn, send_lock, rid, e)
                        except OSError:
                            return
                    continue
                if self._stalled.is_set():
                    continue  # a stalled worker never answers
                try:
                    with send_lock:
                        wire.send_msg(conn, {"id": rid, "ok": True,
                                             "out": out})
                except OSError:
                    return
            finally:
                handoff.task_done()

    def _handle_conn(self, conn):
        send_lock = threading.Lock()
        dead = threading.Event()
        handoff = _stdqueue.Queue()
        threads = [threading.Thread(
            target=self._hb_loop, args=(conn, send_lock, dead),
            name=f"fleet-w{self.index}-hb", daemon=True)]
        threads += [threading.Thread(
            target=self._waiter_loop, args=(conn, send_lock, handoff, dead),
            name=f"fleet-w{self.index}-wait{i}", daemon=True)
            for i in range(self._waiters)]
        for t in threads:
            t.start()
        try:
            while True:
                try:
                    msg = wire.recv_msg(conn)
                except wire.WireError:
                    return
                if msg is None or not isinstance(msg, dict):
                    return
                if "id" not in msg:
                    continue  # pushes flow worker->router only
                rid, op = msg["id"], msg.get("op")
                if op == "score":
                    if self._inject_check():
                        continue  # stalled: accepted, never answered
                    # A frame carrying trace_id was sampled by the
                    # ROUTER — join its trace rather than re-flipping
                    # the local coin.
                    parent = None
                    if "trace_id" in msg:
                        parent = {"trace_id": msg["trace_id"],
                                  "parent_id": msg.get("parent_id")}
                    try:
                        fut = self.service.submit(
                            msg["model"], msg["x"],
                            kind=msg.get("kind", "predict"),
                            trace_parent=parent)
                    except Exception as e:
                        self._send_error(conn, send_lock, rid, e)
                        continue
                    handoff.put((rid, fut))
                elif op == "ping":
                    with send_lock:
                        wire.send_msg(conn, {"id": rid, "ok": True,
                                             "worker": self.index,
                                             "pid": os.getpid()})
                elif op == "stats":
                    stats = self._stats()
                    with send_lock:
                        wire.send_msg(conn, {"id": rid, "ok": True,
                                             "stats": stats})
                elif op == "drain":
                    acct = self.service.drain(
                        deadline_s=float(msg.get("deadline_s", 10.0)))
                    # Every submitted future has settled; give the
                    # waiter pool a bounded window to flush responses
                    # before the ack (an unflushed response would be
                    # re-dispatched by the router's failover path —
                    # correct but noisy).
                    flush_by = time.monotonic() + 5.0
                    while handoff.unfinished_tasks \
                            and time.monotonic() < flush_by:
                        time.sleep(0.01)
                    with self._acct_lock:
                        self._drain_acct = acct
                    with send_lock:
                        wire.send_msg(conn, {"id": rid, "ok": True,
                                             "acct": acct})
                    self._drained.set()
                    return
                else:
                    self._send_error(conn, send_lock, rid,
                                     ValueError(f"unknown op {op!r}"))
        except OSError:
            return
        finally:
            dead.set()
            try:
                conn.close()
            except OSError:
                pass

    def serve_forever(self):
        """Accept router connections until a drain op lands; returns the
        drain accounting dict (None when the listener died first)."""
        self._listener = wire.listen_unix(self.socket_path)
        self._listener.settimeout(0.25)
        while not self._drained.is_set():
            try:
                conn, _ = self._listener.accept()
            except _socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._handle_conn, args=(conn,),
                             name=f"fleet-w{self.index}-conn",
                             daemon=True).start()
        try:
            self._listener.close()
            os.unlink(self.socket_path)
        except OSError:
            pass
        with self._acct_lock:
            return self._drain_acct


def worker_main(opts):
    """The ``serve --worker`` entry point: resolve the device
    (``opts["device"]``, ``cuda`` when None; raises without CUDA), load
    the persisted registry (no fitting in a worker), warm, listen, serve
    until drained. Returns 0 after a clean drain; any failure before
    ready raises, so the process exits nonzero."""
    from flake16_framework_tpu_torch import obs
    from flake16_framework_tpu_torch.obs.slo import SLOConfig
    from flake16_framework_tpu_torch.serve.registry import ModelRegistry
    from flake16_framework_tpu_torch.serve.service import ScoringService

    if not opts.get("registry"):
        raise ValueError("serve --worker requires --registry DIR "
                         "(workers load persisted artifacts)")
    if not opts.get("socket"):
        raise ValueError("serve --worker requires --socket PATH")

    registry = ModelRegistry(opts["registry"], device=opts.get("device"))
    if not registry.load():
        raise ValueError(
            f"serve --worker: no loadable models under {opts['registry']}")

    # SLO only when asked: one worker's failover-absorbed load spike
    # must not shed the whole fleet on a default objective.
    slo_cfg = (SLOConfig(p99_ms=opts.get("slo_p99_ms") or 50.0)
               if opts.get("slo") else None)

    idx = worker_index()
    with ScoringService(registry, buckets=opts.get("buckets"),
                        device=registry.device, slo=slo_cfg,
                        metrics_port=opts.get("metrics_port")) as svc:
        server = WorkerServer(svc, opts["socket"], index=idx)
        obs.manifest_update(verb="serve", fleet_worker=idx,
                            fleet_socket=opts["socket"])
        # The warm's kernel launches, as the manager's log keeps them.
        print(f"{WORKER_READY} {idx} pid={os.getpid()} "
              f"device={registry.device} "
              f"launches={json.dumps(launch_counts())}", flush=True)
        acct = server.serve_forever()
    if acct is not None:
        print("WORKER_DRAINED " + json.dumps(acct), flush=True)
    return 0


# ---------------------------------------------------------------------
# Fleet manager half (parent process)
# ---------------------------------------------------------------------


class WorkerHandle:
    """One managed worker process: identity, spawn state, restart
    accounting, and the seconds from each spawn to its socket accepting
    (``ready_s``, one entry a spawn that ``Fleet.wait_ready`` saw come
    up). All mutation happens under the owning Fleet's lock."""

    __slots__ = ("index", "socket_path", "proc", "env", "log_path",
                 "restarts", "failed", "spawned", "t_spawn", "ready_s",
                 "_ready_for")

    def __init__(self, index, socket_path, log_path):
        self.index = index
        self.socket_path = socket_path
        self.log_path = log_path
        self.proc = None
        self.env = None
        self.restarts = 0
        self.failed = False
        self.spawned = 0
        self.t_spawn = None
        self.ready_s = []
        self._ready_for = 0

    @property
    def pid(self):
        return self.proc.pid if self.proc is not None else None

    def alive(self):
        return self.proc is not None and self.proc.poll() is None


class Fleet:
    """Spawn + supervise N workers over one persisted registry on
    ``device`` (passed to each worker; None = the worker's default,
    ``cuda``). The router connects to ``socket_paths()``; the fleet keeps
    those sockets occupied (restart budget for signal deaths, free
    respawn after clean drain exits) and dumps a dead worker's flight
    ring before replacing it. ``ready_timeout_s`` bounds a start: on an
    H100, three workers over three full-width models were ready 7-10 s
    after their spawn (chip_smoke.py's fleet phases)."""

    def __init__(self, registry_dir, n_workers, *, workdir,
                 buckets=None, max_restarts=3, slo_p99_ms=None,
                 env=None, python=None, ready_timeout_s=120.0,
                 device=None):
        self.registry_dir = registry_dir
        self.n_workers = int(n_workers)
        self.workdir = workdir
        self.buckets = buckets
        self.max_restarts = int(max_restarts)
        self.slo_p99_ms = slo_p99_ms
        self.ready_timeout_s = float(ready_timeout_s)
        self.device = None if device is None else str(device)
        self._base_env = dict(os.environ if env is None else env)
        self._python = python or sys.executable
        self._lock = threading.Lock()
        self._stopping = False
        self.workers = []
        self._monitors = []
        os.makedirs(workdir, exist_ok=True)
        for i in range(self.n_workers):
            self.workers.append(WorkerHandle(
                i, os.path.join(workdir, f"worker{i}.sock"),
                os.path.join(workdir, f"worker{i}.log")))

    # -- spawn -----------------------------------------------------------

    def _worker_env(self, handle, *, strip_inject):
        from flake16_framework_tpu_torch.resilience import inject

        env = dict(self._base_env)
        env[WORKER_ENV] = str(handle.index)
        # The child must import this package regardless of the parent's
        # cwd (an installed dist doesn't need it; a source checkout run
        # from elsewhere does).
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        existing = env.get("PYTHONPATH", "")
        if pkg_parent not in existing.split(os.pathsep):
            env["PYTHONPATH"] = (pkg_parent + os.pathsep + existing
                                 if existing else pkg_parent)
        if strip_inject and env.get(inject.ENV_VAR):
            stripped = inject.strip_process_entries(env[inject.ENV_VAR])
            if stripped:
                env[inject.ENV_VAR] = stripped
            else:
                env.pop(inject.ENV_VAR, None)
        return env

    def _argv(self, handle):
        argv = [self._python, "-m", "flake16_framework_tpu_torch", "serve",
                "--worker", "--socket", handle.socket_path,
                "--registry", self.registry_dir]
        if self.buckets:
            argv += ["--buckets",
                     ",".join(str(b) for b in self.buckets)]
        if self.slo_p99_ms is not None:
            argv += ["--slo", "--slo-p99-ms", str(self.slo_p99_ms)]
        if self.device is not None:
            argv += ["--device", self.device]
        return argv

    def _spawn(self, handle, *, strip_inject):
        handle.env = self._worker_env(handle, strip_inject=strip_inject)
        log = open(handle.log_path, "ab")
        try:
            handle.proc = subprocess.Popen(
                self._argv(handle), stdout=log, stderr=log,
                env=handle.env)
        finally:
            log.close()
        handle.spawned += 1
        handle.t_spawn = time.monotonic()
        t = threading.Thread(target=self._monitor, args=(handle,),
                             name=f"fleet-mon-w{handle.index}",
                             daemon=True)
        t.start()
        self._monitors.append(t)

    def build_kernels(self):
        """Build the kernel libraries once, here, when the workers will
        run on CUDA and a card is present: W workers starting together
        then load them instead of running W compilers each inside the
        ready timeout. Without a card there is nothing to build for; the
        workers fail on their own device check."""
        if torch.device(self.device or "cuda").type != "cuda" \
                or not torch.cuda.is_available():
            return None
        from flake16_framework_tpu_torch.kernels import build

        return build.build(*KERNELS)

    def start(self):
        self.build_kernels()
        for handle in self.workers:
            self._spawn(handle, strip_inject=False)
        self.wait_ready()
        return self

    # -- readiness -------------------------------------------------------

    def _probe(self, handle):
        try:
            sock = wire.connect_unix(handle.socket_path, timeout=0.5)
            sock.close()
            return True
        except OSError:
            return False

    def wait_ready(self, indices=None, timeout_s=None):
        """Block until every (selected) worker's socket accepts — the
        warm bill is paid here, not at the first request — and record
        each spawn's ready time. Raises on a worker that failed before
        listening."""
        deadline = time.monotonic() + (timeout_s or self.ready_timeout_s)
        pending = list(indices if indices is not None
                       else range(self.n_workers))
        while pending:
            for i in list(pending):
                handle = self.workers[i]
                if self._probe(handle):
                    pending.remove(i)
                    with self._lock:
                        if handle._ready_for != handle.spawned:
                            handle._ready_for = handle.spawned
                            handle.ready_s.append(round(
                                time.monotonic() - handle.t_spawn, 3))
                elif not handle.alive() and handle.failed:
                    raise RuntimeError(
                        f"fleet worker {i} failed before ready "
                        f"(rc={handle.proc.returncode}; see "
                        f"{handle.log_path})")
            if pending:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"fleet workers {pending} not ready within "
                        f"{timeout_s or self.ready_timeout_s}s")
                time.sleep(0.1)

    # -- supervision -----------------------------------------------------

    def flight_ring_path(self, handle):
        """The per-worker flight ring path (obs/flight.env_path with the
        worker's environment — the ``.w<i>`` uniquified form), or None
        when the ring is unarmed or unresolvable from the parent."""
        from flake16_framework_tpu_torch.obs import flight

        return flight.env_path(environ=handle.env or self._base_env)

    def _dump_flight(self, handle):
        path = self.flight_ring_path(handle)
        if not path or not os.path.isfile(path):
            return
        from flake16_framework_tpu_torch.obs import flight

        try:
            flight.dump(path)
        except (OSError, ValueError):
            pass  # a corrupt corpse ring must not block the respawn

    def _monitor(self, handle):
        proc = handle.proc
        rc = proc.wait()
        with self._lock:
            if self._stopping or proc is not handle.proc:
                return
            from flake16_framework_tpu_torch import obs

            if rc < 0:
                # Signal death: dump the black box, spend the budget.
                self._dump_flight(handle)
                handle.restarts += 1
                if handle.restarts > self.max_restarts:
                    handle.failed = True
                    obs.event("fleet", action="budget-exhausted",
                              worker=handle.index, rc=rc,
                              restarts=handle.restarts)
                    return
                obs.event("fleet", action="restart", worker=handle.index,
                          rc=rc, restarts=handle.restarts)
                self._spawn(handle, strip_inject=True)
            elif rc == 0:
                # Clean drain exit (rolling restart): free respawn.
                if handle.spawned > 0:
                    obs.event("fleet", action="respawn-drained",
                              worker=handle.index)
                    self._spawn(handle, strip_inject=True)
            else:
                # A worker exiting nonzero could not get its device or
                # load/serve the registry — respawning would crash-loop
                # the budget.
                handle.failed = True
                obs.event("fleet", action="failed", worker=handle.index,
                          rc=rc)

    # -- accessors / teardown --------------------------------------------

    def socket_paths(self):
        return [h.socket_path for h in self.workers]

    def pids(self):
        return [h.pid for h in self.workers]

    def stop(self, timeout_s=10.0):
        """Terminate every worker (SIGTERM → SIGKILL escalation). The
        zero-drop path is the router's ``rolling_restart``/drain — this
        is the unceremonious end-of-run teardown."""
        with self._lock:
            self._stopping = True
            procs = [h.proc for h in self.workers if h.alive()]
        for p in procs:
            try:
                p.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + timeout_s
        for p in procs:
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                    p.wait(5.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        for h in self.workers:
            try:
                os.unlink(h.socket_path)
            except OSError:
                pass

    def __enter__(self):
        try:
            return self.start()
        except BaseException:
            self.stop()
            raise

    def __exit__(self, *exc):
        self.stop()
