"""Kernel cost attribution: ``cost`` events from a counting pass over an
entry point's first call of each signature. The port's counterpart of the
JAX package's ``obs/costs.py``, where XLA's ``cost_analysis()`` of the
compiled program gives the flops and bytes.

``instrument(fn, name, cost_fields=None)`` wraps a callable (one of the
sweep's, grower's or explainer's entry points). Every call bumps
``obs.aot.dispatch_stats()["dispatches"]``, whether telemetry is on or not.
With telemetry on, the first call of each signature runs inside a
counting pass and emits one ``cost`` event under span ``name``
(``report --attrib`` joins on it):

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  call's aten ops (its formulas, ``flop_registry``, applied in the pass's
  one dispatch mode: a CPU test holds the total equal to
  ``FlopCounterMode``'s own), plus the analytic work
  (``kernels/hist.work``, ``kernels/treeshap_unit.work``) of every K1
  and K2 launch inside it;
- ``bytes``: the operand and output bytes of every aten op, plus the
  kernels' work bytes;
- ``compile_s``: the wall of the kernel builds and loads inside the call
  (0 when none), with the build cache's ``cache_hits``/``cache_misses``;
- ``pass_s``: the wall of the counted call, the pass's cost included;
- the extras of ``cost_fields(args, kwargs)`` (the grower's
  ``stage_flops``).

The pass counts on the calling thread only (torch's dispatch modes are
per thread) and costs about one Python call an aten op, plus one host
read a kernel launch for the launch's work: it is paid once a signature,
with telemetry on. One mode, not ``FlopCounterMode`` beside a byte
counter: ``FlopCounterMode``'s dispatch imports ``torch._dynamo`` at its
first op (seconds, once a process) and tries a decomposition of every op
outside its table (about twice this mode's cost an op). The signature is the JAX package's: the values of the
static keyword arguments, and the type of every other Python scalar and
the shape and dtype of every tensor (``key=`` replaces it where the
arguments are not tensors). A call made inside another instrumented call,
or inside a graph capture, is counted as a dispatch and runs plain: it is
part of the outer program, as a call inside a traced JAX program is part
of that program.
"""

import contextlib
import functools
import threading
import time

import numpy as np
import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _disable_current_modes,
)
from torch.utils.flop_counter import flop_registry

from flake16_framework_tpu_torch.kernels import build
from flake16_framework_tpu_torch.obs import aot, core


def _nbytes(x):
    """Bytes of the tensors in ``x`` (a tensor, or a list or tuple of
    them, as aten ops take and return them)."""
    if isinstance(x, torch.Tensor):
        return x.nbytes
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(e) for e in x)
    return 0


class _Counter(TorchDispatchMode):
    """Flops (``flop_registry``'s formulas) and operand and output bytes of
    every aten op run under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    @classmethod
    def _should_skip_dynamo(cls):
        # Unwrapped: torch would wrap this dispatch in a dynamo guard,
        # whose first call imports torch._dynamo.
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.bytes += _nbytes(args) + _nbytes(tuple(kwargs.values())) \
            + _nbytes(out)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        return out


class _Pass:
    """What one counting pass has counted (``flops``, ``bytes``,
    ``compile_s``, ``cache_hits``, ``cache_misses``)."""

    def __init__(self):
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.compile_s = 0.0
        self.flops = self.bytes = 0.0
        self.cache_hits = self.cache_misses = 0

    def kernel(self, work):
        """Add one launch's analytic work, computed outside the pass's
        own counters."""
        with _disable_current_modes():
            w = work()
        self.kernel_flops += w["flops"]
        self.kernel_bytes += w["bytes"]


@contextlib.contextmanager
def counting_pass():
    """Count the block's aten ops and kernel launches on this thread;
    yields the ``_Pass``, whose totals are set when the block ends."""
    p = _Pass()
    cache0 = build.cache_stats()
    mode = _Counter()
    with build.counting(p), mode:
        yield p
    cache1 = build.cache_stats()
    p.flops = float(mode.flops) + p.kernel_flops
    p.bytes = float(mode.bytes) + p.kernel_bytes
    p.cache_hits = cache1["hits"] - cache0["hits"]
    p.cache_misses = cache1["misses"] - cache0["misses"]


def _leaf_key(v, static):
    if isinstance(v, (torch.Tensor, np.ndarray)):
        return (tuple(v.shape), str(v.dtype))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_leaf_key(e, static) for e in v))
    if isinstance(v, dict):
        return tuple(sorted((k, _leaf_key(e, static)) for k, e in v.items()))
    if v is None or static:
        return repr(v)
    return type(v).__name__


def signature(args, kwargs, static=()):
    """The JAX package's dispatch key of a call: the static keyword
    arguments by value, every tensor by shape and dtype, every other
    Python scalar by type (None by value: it changes the program's
    structure, as a pytree's structure does)."""
    return (tuple(sorted((k, repr(v)) for k, v in kwargs.items()
                         if k in static)),
            _leaf_key(args, False),
            tuple(sorted((k, _leaf_key(v, False)) for k, v in kwargs.items()
                         if k not in static)))


class _Instrumented:
    """``fn`` with the dispatch census and, with telemetry on, one
    counting pass a signature (see the module docstring)."""

    def __init__(self, fn, name, static_argnames=(), cost_fields=None,
                 key=None):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self.name = name
        self._static = frozenset(static_argnames)
        self._cost_fields = cost_fields
        self._key = key
        self._seen = set()
        self._lock = threading.Lock()

    def signature(self, args, kwargs):
        if self._key is not None:
            return self._key(args, kwargs)
        return signature(args, kwargs, self._static)

    def __call__(self, *args, **kwargs):
        aot.bump("dispatches")
        if core._state is None or aot.depth() or build.capturing():
            with aot.inside():
                return self._fn(*args, **kwargs)
        sig = self.signature(args, kwargs)
        with self._lock:
            fresh = sig not in self._seen
            self._seen.add(sig)
        if not fresh:
            with aot.inside():
                return self._fn(*args, **kwargs)
        aot.bump("compiles")
        t0 = time.perf_counter()
        with aot.inside(), counting_pass() as p:
            out = self._fn(*args, **kwargs)
        pass_s = time.perf_counter() - t0
        extra = {}
        if self._cost_fields is not None:
            extra = dict(self._cost_fields(args, kwargs) or {})
        core.event("cost", span=self.name, flops=p.flops, bytes=p.bytes,
                   compile_s=round(p.compile_s, 6),
                   cache_hits=p.cache_hits, cache_misses=p.cache_misses,
                   pass_s=round(pass_s, 6), **extra)
        return out


def instrument(fn, name, static_argnames=(), cost_fields=None, key=None):
    """Wrap ``fn`` so its dispatches are counted and, with telemetry on,
    its first call of each signature emits a ``cost`` event under span
    ``name``. ``cost_fields``: (args, kwargs) -> dict of extra event
    fields (or None); ``key``: (args, kwargs) -> signature, in place of
    the default."""
    return _Instrumented(fn, name, static_argnames, cost_fields, key)
