"""The executable store's cache: one CUDA graph per (owner, signature)
around one eager body, and the process's dispatch census. The port's
counterpart of the JAX package's ``obs/aot.py``, whose cache keeps one
ahead-of-time compiled XLA executable per signature: a program built once
per shape and dispatched many times is, in PyTorch, a ``CUDAGraph``
captured once per shape and replayed.

``AotExecutableCache(body, name, key)`` wraps ``body(*consts, x)``:
``consts`` (a served model's prepared tensors) are baked into the graph by
address, and ``x``, the padded host batch, is copied into the graph's
static input at every call. ``signature(args, kwargs)`` is ``(name,
*key(args, kwargs))``, the keys the serving store's warm manifest has
always held. A graph belongs to an owner (a model id): models of equal
shapes share a signature but not a graph, and ``drop(owner)`` forgets an
owner's graphs when its model is reloaded.

- ``warm`` runs the body once on a side stream (kernel libraries, the
  SHAP unit's tables and cuBLAS's workspace come to exist outside the
  capture), then captures it into a graph with a private memory pool and
  static input and output buffers. A capture error propagates: a model
  that cannot be captured stops the service at start, as a compile
  error does in the JAX package.
- ``__call__`` copies the batch into the static input, replays the graph
  and clones the static output on the device, all under the graph's lock
  (two dispatcher threads must not share its buffers while both are in
  flight), and returns the clone. A signature not warmed yet is captured
  at its first call.
- Kernel launches made while capturing are the capture's
  (``kernels/build.capture_tally``): each replay adds them to the
  wrappers' counts, so a replayed K2 counts as a launch as an eager one
  does.
- Every call bumps ``dispatch_stats()["dispatches"]`` and every capture
  ``["compiles"]``, whether telemetry is on or not. With telemetry on, a
  capture emits one ``cost`` event under the cache's name: ``flops`` and
  ``bytes`` from the warm-up run, counted as ``obs/costs.py`` counts, and
  ``compile_s`` the capture's wall.

There is no fallback on the card. Where the JAX package's cache falls back
to the jitted function for a signature it cannot dispatch, this one
raises on ``cuda``: the port never lets another path stand in for the
device's own. Only on a ``cpu`` device, which the caller asked for, does
the cache run the eager body at every call, since there is no graph on the
CPU; that is the kernels' rule for their plain versions. A stand-in
``capture`` (tests) exercises the graph bookkeeping on any device.

``cache_stats()`` is the kernel build cache's hits and misses
(``kernels/build.py``), where the JAX package counts XLA's persistent
compilation cache. ``obs/core.py`` and ``obs/metrics.py`` read this module
through ``sys.modules`` only.
"""

import contextlib
import functools
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from flake16_framework_tpu_torch.kernels import build
from flake16_framework_tpu_torch.obs import core

# Every instrumented call (``obs/costs.instrument``) and every dispatch
# through a cache bumps "dispatches"; every capture, and every counting
# pass of an instrument, "compiles". Callers measure a region by delta.
_DISPATCH_STATS = {"dispatches": 0, "compiles": 0}
_STATS_LOCK = threading.Lock()

# Per thread: how many instrumented calls and cache bodies are running
# (``depth``), whether the census is suspended (``uncounted``), and the
# side streams of the captures (``streams``).
_local = threading.local()


def depth():
    """Instrumented calls and cache bodies open on this thread."""
    return getattr(_local, "depth", 0)


@contextlib.contextmanager
def inside():
    """Mark the block as part of an outer program: instrumented calls in
    it are counted as dispatches and run plain."""
    _local.depth = depth() + 1
    try:
        yield
    finally:
        _local.depth -= 1


@contextlib.contextmanager
def uncounted():
    """Run the block without bumping the census on this thread."""
    prev = getattr(_local, "uncounted", False)
    _local.uncounted = True
    try:
        yield
    finally:
        _local.uncounted = prev


def bump(field, n=1):
    """Add ``n`` to ``field`` of the dispatch census (nothing while this
    thread runs a ``traceable()`` body)."""
    if getattr(_local, "uncounted", False):
        return
    with _STATS_LOCK:
        _DISPATCH_STATS[field] += n


def dispatch_stats():
    """{"dispatches", "compiles"} counted across every cache and
    instrument of this process."""
    with _STATS_LOCK:
        return dict(_DISPATCH_STATS)


def cache_stats():
    """{"hits", "misses"} of the kernel build cache in this process: a hit
    is a library already built under its hashed name, a miss a run of
    ``nvcc``."""
    stats = build.cache_stats()
    return {"hits": stats["hits"], "misses": stats["misses"]}


def _thread_stream(device):
    """This thread's side stream on ``device``, made at its first use. One
    a thread, not one a capture: each stream cuBLAS runs on gets a
    workspace of its own, and the caching allocator reuses a freed block
    only on the stream that freed it."""
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


@contextlib.contextmanager
def _side_stream(device):
    """Run the block on this thread's side stream of ``device``, ordered
    after the current stream's work and before its next; nothing off the
    card."""
    if device.type != "cuda":
        yield
        return
    cur = torch.cuda.current_stream(device)
    stream = _thread_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        yield
    cur.wait_stream(stream)


def cuda_graph_capture(fn, static_x):
    """Capture ``fn(static_x)`` into a ``torch.cuda.CUDAGraph`` with a
    private memory pool, on this thread's side stream, thread-locally
    (other threads may dispatch while one captures). Returns (replay,
    static output). ``torch.cuda.graph`` would also synchronise the card
    and empty the allocator's cache before each capture: a store captures
    one graph a (model, kind, bucket), and each emptying frees what the
    next warm-up run allocates again."""
    graph = torch.cuda.CUDAGraph()
    with _side_stream(static_x.device):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn(static_x)
        except BaseException:
            # End the broken capture so that the stream is usable; the
            # body's error is the one to raise.
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
    return graph.replay, out


class GraphInfo(NamedTuple):
    """What ``AotExecutableCache.graphs`` tells of one graph: the kernel
    launches a replay adds ({wrapper: n}) and the capture's wall (s)."""

    launches: dict
    capture_s: float


class _Graph:
    """One captured signature of one owner."""

    __slots__ = ("consts", "x", "out", "replay", "launches", "capture_s",
                 "lock")

    def __init__(self, consts, x, out, replay, launches, capture_s):
        self.consts = consts  # kept alive: the graph reads them by address
        self.x = x
        self.out = out
        self.replay = replay
        self.launches = launches
        self.capture_s = capture_s
        self.lock = threading.Lock()


class AotExecutableCache:
    """CUDA graphs of ``body(*consts, x, **kwargs)``, one per (owner,
    signature), on ``device`` (see the module docstring). ``key(args,
    kwargs)`` gives a signature's tuple after the name; ``capture(fn,
    static_x)`` -> (replay, static output) stands in for
    ``cuda_graph_capture``."""

    def __init__(self, body, name, key, *, device, capture=None):
        self._body = body
        self.name = name
        self._key = key
        self.device = torch.device(device)
        self._capture = capture
        if capture is None and self.device.type == "cuda":
            self._capture = cuda_graph_capture
        self._graphs = {}   # (owner, signature) -> _Graph
        self._pending = {}  # (owner, signature) -> Event of its capture
        self._lock = threading.Lock()  # guards both; held for no call

    def signature(self, args, kwargs):
        """The dispatch key of a call: (name, *key(args, kwargs))."""
        return (self.name, *self._key(args, kwargs))

    def traceable(self):
        """The eager body, as a function that bumps no dispatch count on
        its thread while it runs: the audit runs it, and stays out of the
        census."""
        body = self._body

        @functools.wraps(body)
        def run(*args, **kwargs):
            with uncounted():
                return body(*args, **kwargs)

        return run

    def graphs(self):
        """{(owner, signature): GraphInfo} of every captured graph."""
        with self._lock:
            return {k: GraphInfo(dict(g.launches), g.capture_s)
                    for k, g in self._graphs.items()}

    def drop(self, owner):
        """Forget every graph of ``owner`` (a reloaded model)."""
        with self._lock:
            for k in [k for k in self._graphs if k[0] == owner]:
                del self._graphs[k]

    def warm(self, owner, *args, **kwargs):
        """Capture ``owner``'s graph for this signature unless it exists
        (on the CPU: run the body once). Returns the signature. Errors
        propagate."""
        sig = self.signature(args, kwargs)
        if self._capture is None:
            with inside():
                self._body(*args[:-1], torch.as_tensor(args[-1]), **kwargs)
        else:
            self._graph(owner, sig, args, kwargs)
        return sig

    def _graph(self, owner, sig, args, kwargs):
        """The owner's graph of this signature, captured now unless it
        exists for these very consts (a graph captured on a model object
        that a reload has since replaced is stale). One thread captures a
        key while the others wait; no lock is held over a capture, which
        runs the body."""
        key = (owner, sig)
        while True:
            with self._lock:
                graph = self._graphs.get(key)
                if graph is not None and all(
                        a is b for a, b in zip(graph.consts, args[:-1])):
                    return graph
                pending = self._pending.get(key)
                mine = pending is None
                if mine:
                    pending = self._pending[key] = threading.Event()
            if mine:
                break
            pending.wait()
        try:
            graph = self._new_graph(args, kwargs)
            with self._lock:
                self._graphs[key] = graph
            return graph
        finally:
            with self._lock:
                del self._pending[key]
            pending.set()

    def _new_graph(self, args, kwargs):
        from flake16_framework_tpu_torch.obs import costs

        *consts, x = args
        static_x = torch.empty(tuple(np.shape(x)), dtype=torch.float32,
                               device=self.device)
        static_x.copy_(torch.as_tensor(x))

        def fn(xs):
            with inside():
                return self._body(*consts, xs, **kwargs)

        with _side_stream(self.device):
            if core._state is not None:
                with costs.counting_pass() as counted:
                    fn(static_x)
            else:
                counted = None
                fn(static_x)
        bump("compiles")
        t0 = time.perf_counter()
        with build.capture_tally() as tally:
            replay, out = self._capture(fn, static_x)
        capture_s = time.perf_counter() - t0
        if counted is not None:
            core.event("cost", span=self.name, flops=counted.flops,
                       bytes=counted.bytes, compile_s=round(capture_s, 6),
                       cache_hits=counted.cache_hits,
                       cache_misses=counted.cache_misses)
        return _Graph(tuple(consts), static_x, out, replay, dict(tally),
                      capture_s)

    def __call__(self, owner, *args, **kwargs):
        bump("dispatches")
        if self._capture is None:
            with inside():
                return self._body(*args[:-1], torch.as_tensor(args[-1]),
                                  **kwargs)
        graph = self._graph(owner, self.signature(args, kwargs), args,
                            kwargs)
        with graph.lock:
            with core.region("store.copy_in"):
                graph.x.copy_(torch.as_tensor(args[-1]))
            with core.region("store.replay"):
                graph.replay()
            with core.region("store.clone"):
                out = graph.out.clone()
        build.add_launches(graph.launches)
        return out
