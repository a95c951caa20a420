"""Process-wide telemetry: spans, counters/gauges, JSONL sink, manifest,
heartbeat (the JAX package's ``obs/core.py`` for this package; events and
manifests follow the same schema, ``obs/schema.py``).

Disabled by default and zero-overhead when off: the switch is
``F16_TELEMETRY`` (unset/empty = off; ``1`` = on at the default root
``_scratch/telemetry`` under the CWD; any other value = the root
directory), read by ``configure_from_env`` at the command line's entry
(``__main__``), never at import. Every public entry point's first action
is a single ``_state is None`` check, and ``span()`` returns one shared
no-op object.

When on, one run = one directory ``<root>/run-<token>/`` holding
``events.jsonl`` (schema.EVENT_FIELDS; atomic appends — O_APPEND +
single write, safe under concurrent threads and processes) and
``manifest.json`` (schema.MANIFEST_FIELDS; enriched in place). A daemon
heartbeat thread stamps liveness every ``F16_TELEMETRY_HEARTBEAT_S``
(default 60 s, 0 disables). With ``F16_FLIGHT`` set as well, every event
is mirrored into the crash-surviving flight ring (``obs/flight.py``).

The ``scores profile=DIR`` hook is this subsystem's ``profiler_trace``:
a ``torch.profiler`` capture (CPU activity, and CUDA activity on a
``cuda`` run) written as a Chrome trace under DIR, with a ``profile``
event; it runs whether telemetry is on or not. ``xprof_trace`` arms one
such capture per (process, tag) from ``F16_XPROF``.
``record_device_manifest`` stamps the device facts (the JAX package's
``record_jax_manifest``, read from torch). The lock-order witness
(``obs/lockwatch.py``) is armed before this module's locks are made.
"""

import atexit
import json
import os
import random
import subprocess
import sys
import threading
import time

from flake16_framework_tpu_torch.obs import schema

_lock = threading.Lock()
_state = None  # _RunState when enabled; module-level None = the fast path
_run_seq = 0   # disambiguates same-second reconfigures within one process
_flight = None  # obs.flight.FlightRecorder when F16_FLIGHT armed
_atexit_armed = False
_xprof_done = set()  # tags already captured (one capture per process+tag)
_profiling = threading.Lock()  # held while a profiler_trace captures


class _NullSpan:
    """The shared no-op span (disabled path): one allocation per process."""

    __slots__ = ()
    wall_s = 0.0
    cold = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **fields):
        return self


_NULL_SPAN = _NullSpan()


class _RunState:
    __slots__ = ("run", "dir", "fd", "t0", "counters", "gauges", "seen",
                 "hb_stop", "hb_thread")

    def __init__(self, run, run_dir, fd):
        self.run = run
        self.dir = run_dir
        self.fd = fd
        self.t0 = time.time()
        self.counters = {}
        self.gauges = {}  # name -> last emitted value (manifest flush)
        self.seen = set()  # (span name, key) pairs already timed once
        self.hb_stop = None
        self.hb_thread = None


# -- sink ---------------------------------------------------------------


def append_jsonl(path, obj):
    """Atomically append one JSON object line to ``path``: O_APPEND + a
    single write(2), so concurrent writers (threads or processes)
    interleave whole lines, never fragments."""
    line = (json.dumps(obj) + "\n").encode()
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line)
    finally:
        os.close(fd)


def _emit(state, obj):
    obj.setdefault("ts", round(time.time(), 4))
    obj.setdefault("run", state.run)
    line = (json.dumps(obj) + "\n").encode()
    with _lock:
        os.write(state.fd, line)
        flt = _flight
        if flt is not None:
            # Mirror into the crash-surviving ring under the same lock, so
            # the ring's order is the sink's when threads emit at once.
            try:
                flt.record(obj)
            except (OSError, ValueError):
                pass


# -- lifecycle ----------------------------------------------------------


def enabled():
    return _state is not None


def current_run_dir():
    """The active run directory, or None when telemetry is off."""
    return _state.dir if _state is not None else None


def default_root():
    raw = os.environ.get("F16_TELEMETRY", "")
    if raw and raw != "1":
        return raw
    return os.path.join(os.getcwd(), "_scratch", "telemetry")


def configure(root=None, heartbeat_s=None):
    """Enable telemetry into ``<root>/run-<token>/`` (reconfiguring shuts
    the previous run down first). The command line calls it through
    ``configure_from_env``; tests and other callers may call it directly.
    Returns the run directory."""
    global _state, _run_seq, _atexit_armed
    shutdown()
    root = root or default_root()
    run = time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}"
    with _lock:
        _run_seq += 1
        if _run_seq > 1:  # same second + same pid must not share a dir
            run += f".{_run_seq}"
        if not _atexit_armed:
            # Runs that never call shutdown() still get the exit-time
            # manifest facts and a closed sink.
            atexit.register(shutdown)
            _atexit_armed = True
    run_dir = os.path.join(root, f"run-{run}")
    os.makedirs(run_dir, exist_ok=True)
    fd = os.open(os.path.join(run_dir, schema.EVENTS_FILE),
                 os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    _state = _RunState(run, run_dir, fd)
    _write_manifest_base(_state)
    _arm_flight(run_dir)
    if heartbeat_s is None:
        heartbeat_s = float(os.environ.get("F16_TELEMETRY_HEARTBEAT_S",
                                           "60") or 0)
    if heartbeat_s > 0:
        start_heartbeat(heartbeat_s)
    return run_dir


def configure_from_env():
    """``configure()`` when ``F16_TELEMETRY`` is set; the run directory,
    or None when telemetry stays off."""
    if os.environ.get("F16_TELEMETRY"):
        return configure()
    return None


def shutdown():
    """Stop the heartbeat, close the sink and the flight ring, return to
    the disabled state. The gauges' last values are stamped into the
    manifest first, while the sink is still up."""
    global _state, _flight
    if _state is not None:
        _finalize_manifest()
        # A beat in flight finishes into both the sink and the ring before
        # either closes: the ring stays the sink's tail.
        stop_heartbeat(_state)
    state, _state = _state, None
    flt, _flight = _flight, None
    if flt is not None:
        flt.close()
    if state is None:
        return
    with _lock:
        os.close(state.fd)


def _arm_flight(run_dir):
    """Arm the crash-surviving flight ring when F16_FLIGHT is set (off by
    default, same contract as the sink). Once armed, ``_emit`` mirrors
    every event into the ring."""
    global _flight
    from flake16_framework_tpu_torch.obs import flight as _flightmod

    path = _flightmod.env_path(run_dir=run_dir)
    if not path:
        return
    try:
        _flight = _flightmod.FlightRecorder(path)
    except OSError:
        _flight = None
        return
    event("flight", action="armed", path=str(path),
          capacity=_flight.capacity)


def _finalize_manifest():
    """Merge the kernel build cache's facts and the gauges' last values
    into the manifest: where the kernels are built (``kernel_build_dir``,
    in place of the JAX package's ``jax_cache_dir``) and how often this
    process hit or missed that cache, under the JAX package's
    ``jax_cache_hits``/``jax_cache_misses``. Called at shutdown and on
    every heartbeat, so a killed serving process keeps its aggregates and
    its final queue depth and p99. Reads ``kernels.build`` and ``obs.aot``
    through ``sys.modules`` only: telemetry never imports either."""
    fields = {}
    build = sys.modules.get("flake16_framework_tpu_torch.kernels.build")
    if build is not None:
        fields["kernel_build_dir"] = str(build.BUILD_DIR)
    aot = sys.modules.get("flake16_framework_tpu_torch.obs.aot")
    if aot is not None:
        stats = aot.cache_stats()
        fields["jax_cache_hits"] = int(stats["hits"])
        fields["jax_cache_misses"] = int(stats["misses"])
    state = _state
    if state is not None and state.gauges:
        fields["gauges"] = dict(state.gauges)
    if fields:
        manifest_update(**fields)


# -- spans --------------------------------------------------------------


class Span:
    """Timed region. ``cold`` is True on the first occurrence of
    (name, key) in this process. ``counts`` (a callable returning
    {field: int}, or None) is read at entry and exit, and the span
    carries each field's change across it."""

    __slots__ = ("_state", "name", "key", "fields", "t0", "wall_s", "cold",
                 "_counts", "_counts0")

    def __init__(self, state, name, key, fields, counts=None):
        self._state = state
        self.name = name
        self.key = key
        self.fields = fields
        self.wall_s = 0.0
        self.cold = False
        self._counts = counts
        self._counts0 = None

    def add(self, **fields):
        self.fields.update(fields)
        return self

    def __enter__(self):
        if self._counts is not None:
            self._counts0 = self._counts()
        self.t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.wall_s = time.time() - self.t0
        if self._counts is not None:
            self.fields.update({k: v - self._counts0[k]
                                for k, v in self._counts().items()})
        state = self._state
        seen_key = (self.name, self.key)
        with _lock:
            self.cold = seen_key not in state.seen
            state.seen.add(seen_key)
        ev = {"kind": "span", "name": self.name,
              "wall_s": round(self.wall_s, 6), "cold": self.cold,
              "tid": threading.get_ident()}
        if exc_type is not None:
            ev["error"] = exc_type.__name__
        ev.update(self.fields)
        _emit(state, ev)
        return False


def span(name, key=None, counts=None, **fields):
    """``with obs.span("scores.fit", key=family): ...`` — no-op when off
    (``counts`` is then never called)."""
    state = _state
    if state is None:
        return _NULL_SPAN
    return Span(state, name, key, fields, counts)


# -- counters and gauges ------------------------------------------------


def counter_add(name, inc=1, **fields):
    """Add to a monotonic counter and emit the post-increment total."""
    state = _state
    if state is None:
        return
    with _lock:
        total = state.counters.get(name, 0) + inc
        state.counters[name] = total
    _emit(state, {"kind": "counter", "name": name, "inc": inc,
                  "total": total, **fields})


def gauge(name, value, **fields):
    state = _state
    if state is None or value is None:
        return
    value = round(float(value), 4)
    with _lock:  # last-value, flushed into the manifest; dict writes
        state.gauges[name] = value  # race from serve worker threads
    _emit(state, {"kind": "gauge", "name": name, "value": value, **fields})


def event(kind, **fields):
    """Emit a raw event of a schema-known kind."""
    state = _state
    if state is None:
        return
    _emit(state, {"kind": kind, **fields})


def host_rss_peak_mb():
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024


def device_memory_peak_mb():
    """The CUDA allocator's peak (``torch.cuda.max_memory_allocated``) in
    MB, or None where the process has no CUDA context. Never imports
    torch or initializes CUDA itself, and reads only the allocator's
    counters: it does not synchronize the device."""
    torchmod = sys.modules.get("torch")
    if torchmod is None:
        return None
    try:
        if not torchmod.cuda.is_initialized():
            return None
        return torchmod.cuda.max_memory_allocated() / 1e6
    except (RuntimeError, AttributeError):
        return None


def emit_memory_gauges():
    """Stamp the standard memory gauges (host RSS peak; device peak where
    the process has a CUDA context)."""
    if _state is None:
        return
    gauge("host_rss_peak_mb", host_rss_peak_mb())
    gauge("device_mem_peak_mb", device_memory_peak_mb())


# -- per-request trace context ------------------------------------------


def mint_trace(parent=None):
    """Trace context for one request: ``{trace_id, span_id[, parent_id]}``
    or None when telemetry is off or the request loses the
    ``F16_TRACE_SAMPLE`` coin flip (default 1.0 = every request; 0
    disables). Minted at ``submit()`` and carried through the batcher to
    the response."""
    if _state is None:
        return None
    try:
        rate = float(os.environ.get("F16_TRACE_SAMPLE", "1") or 0.0)
    except ValueError:
        rate = 0.0
    if rate <= 0.0 or (rate < 1.0 and random.random() >= rate):
        return None
    ctx = {"trace_id": os.urandom(8).hex(), "span_id": os.urandom(4).hex()}
    if parent:
        ctx["parent_id"] = parent.get("span_id")
        ctx["trace_id"] = parent.get("trace_id", ctx["trace_id"])
    return ctx


def adopt_trace(parent):
    """Adopt a trace context minted in ANOTHER process: a fleet worker
    receiving ``trace_id``/``parent_id`` wire fields joins the router's
    trace with a fresh local span id and no second ``F16_TRACE_SAMPLE``
    coin flip (the router already decided). None when ``parent`` is falsy
    or telemetry is off in this process."""
    if _state is None or not parent:
        return None
    tid = parent.get("trace_id")
    if not tid:
        return None
    ctx = {"trace_id": tid, "span_id": os.urandom(4).hex()}
    pid = parent.get("parent_id") or parent.get("span_id")
    if pid:
        ctx["parent_id"] = pid
    return ctx


# -- manifest -----------------------------------------------------------


def _git_sha():
    try:
        repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        r = subprocess.run(["git", "rev-parse", "HEAD"], cwd=repo,
                           capture_output=True, text=True, timeout=10)
        return r.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _env_fingerprint():
    prefixes = ("F16_", "BENCH_", "GRID_", "CUDA_", "TORCH_")
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(prefixes)}


def _write_manifest_base(state):
    manifest = {
        "schema": schema.MANIFEST_SCHEMA,
        "run": state.run,
        "started_ts": round(state.t0, 4),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "hostname": os.uname().nodename,
        "pid": os.getpid(),
        "git_sha": _git_sha(),
        "env": _env_fingerprint(),
    }
    _dump_manifest(state, manifest)


def _dump_manifest(state, manifest):
    from flake16_framework_tpu_torch.utils.atomic import atomic_write

    path = os.path.join(state.dir, schema.MANIFEST_FILE)
    with atomic_write(path, "w") as fd:
        json.dump(manifest, fd, indent=1, default=str)


def manifest_update(**fields):
    """Merge facts into manifest.json (atomic read-modify-replace)."""
    state = _state
    if state is None:
        return
    path = os.path.join(state.dir, schema.MANIFEST_FILE)
    with _lock:
        try:
            with open(path) as fd:
                manifest = json.load(fd)
        except (OSError, ValueError):
            manifest = {"schema": schema.MANIFEST_SCHEMA, "run": state.run,
                        "started_ts": round(state.t0, 4),
                        "argv": list(sys.argv),
                        "python": sys.version.split()[0],
                        "env": _env_fingerprint()}
        manifest.update(fields)
        _dump_manifest(state, manifest)


def record_device_manifest(device, devices=None):
    """Stamp the device facts into the manifest, under the JAX package's
    names: ``backend`` (the torch device type, ``cuda`` or ``cpu``),
    ``device_kind`` (``torch.cuda.get_device_name``, or ``cpu``),
    ``device_count``, and ``torch_version`` and ``cuda_version`` in place
    of ``jax_version``. With ``devices``, the device list a sweep splits
    its config batches over, ``device_count`` is its length and
    ``mesh_shape`` ``{"config": D}``, as the JAX package records its
    mesh. No-op when off."""
    if _state is None:
        return
    import torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    fields = dict(
        backend=device.type,
        device_kind=torch.cuda.get_device_name(device) if cuda else "cpu",
        device_count=torch.cuda.device_count() if cuda else 1,
        torch_version=torch.__version__, cuda_version=torch.version.cuda)
    if devices is not None:
        fields.update(device_count=len(devices),
                      mesh_shape={"config": len(devices)})
    manifest_update(**fields)


# -- heartbeat ----------------------------------------------------------


def start_heartbeat(interval_s=60.0):
    """Start (or restart) the liveness thread: one ``heartbeat`` event per
    interval with uptime, peak RSS, device memory, and the counter
    snapshot. Daemon — never blocks process exit."""
    state = _state
    if state is None:
        return
    stop_heartbeat(state)
    stop = threading.Event()

    def beat():
        while not stop.wait(interval_s):
            st = _state
            if st is not state:
                return
            with _lock:
                counters = dict(state.counters)
            ev = {"kind": "heartbeat",
                  "uptime_s": round(time.time() - state.t0, 1),
                  "rss_mb": host_rss_peak_mb(), "counters": counters}
            dev = device_memory_peak_mb()
            if dev is not None:
                ev["device_mem_mb"] = round(dev, 1)
            _emit(state, ev)
            try:
                _finalize_manifest()
            except (OSError, ValueError):
                pass

    t = threading.Thread(target=beat, name="f16-telemetry-heartbeat",
                         daemon=True)
    state.hb_stop, state.hb_thread = stop, t
    t.start()


def stop_heartbeat(state=None):
    state = state if state is not None else _state
    if state is None or state.hb_stop is None:
        return
    state.hb_stop.set()
    state.hb_thread.join(timeout=5)
    state.hb_stop = state.hb_thread = None


# -- profiler backend ---------------------------------------------------


def _device_events(prof):
    """CUDA device events in a finished capture (the profiler's raw
    events: building its host-side event tree takes tens of seconds on a
    sweep)."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA)


class profiler_trace:
    """Context manager: a ``torch.profiler`` capture of the block, written
    on exit as a Chrome trace ``<trace_dir>/<host>.<pid>.<ms>.pt.trace.json``
    (``path``; ``obs/trace.summarize_device_trace`` reads it), with a
    ``profile`` event at entry. It captures CPU activity, and CUDA
    activity when ``device`` is a CUDA device: there it raises rather than
    write a CPU-only trace, when this PyTorch cannot trace CUDA or the
    capture holds no device event. ``trace_dir=None`` is a no-op, so
    callers pass their optional profile knob straight through. Works with
    telemetry off (an explicit profile request stands on its own); the
    event is emitted only when the sink is up. One capture runs at a time:
    a second raises, or with ``if_free`` does nothing."""

    def __init__(self, trace_dir, device=None, if_free=False):
        self.trace_dir = trace_dir
        self.device = device
        self.if_free = if_free
        self.path = None
        self._prof = None
        self._cuda = False

    def __enter__(self):
        if self.trace_dir is None:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        self._cuda = self.device is not None and \
            torch.device(self.device).type == "cuda"
        if self._cuda:
            if ProfilerActivity.CUDA not in \
                    torch.profiler.supported_activities():
                raise RuntimeError(
                    "profile=: this PyTorch cannot trace CUDA activity; "
                    "no CPU-only trace of a cuda run is written")
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        if not _profiling.acquire(blocking=False):
            if self.if_free:
                return self
            raise RuntimeError("profile=: another capture is running")
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        except BaseException:
            self._prof = None
            _profiling.release()
            raise
        event("profile", trace_dir=str(self.trace_dir))
        return self

    def __exit__(self, exc_type, exc, tb):
        prof, self._prof = self._prof, None
        if prof is None:
            return False
        try:
            if self._cuda and exc_type is None:
                import torch

                torch.cuda.synchronize(self.device)
            prof.__exit__(exc_type, exc, tb)
            if exc_type is None and self._cuda and not _device_events(prof):
                raise RuntimeError(
                    "profile=: the capture of a cuda run holds no CUDA "
                    "activity; no CPU-only trace is written")
            self.path = os.path.join(
                self.trace_dir, f"{os.uname().nodename}.{os.getpid()}."
                f"{int(time.time() * 1000)}.pt.trace.json")
            prof.export_chrome_trace(self.path)
        finally:
            _profiling.release()
        return False


def xprof_trace(tag, device=None):
    """Device-profiler hook: one ``profiler_trace`` capture per (process,
    tag) into ``$F16_XPROF/<tag>``, armed around the plan and serve
    dispatch sites. Unarmed (variable unset) or already captured: the
    no-op ``profiler_trace(None)``; while another capture runs (a
    ``profile=`` run, or the other dispatcher thread), it does nothing."""
    trace_dir = os.environ.get("F16_XPROF", "")
    if not trace_dir or tag in _xprof_done:
        return profiler_trace(None)
    _xprof_done.add(tag)
    return profiler_trace(os.path.join(trace_dir, tag), device,
                          if_free=True)
