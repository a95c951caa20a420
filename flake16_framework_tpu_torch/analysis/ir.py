"""The audit's recorder: a recorded run of each real entry point, the
port's counterpart of the JAX package's ``analysis/ir.py``.

The JAX audit traces each entry point to a closed jaxpr at abstract
inputs and walks its primitives. The port cannot: its growers are host
loops that read the device once a step or a level (``ops/trees.py``),
the SHAP work list is packed on the host (``ops/treeshap.py``), and K1
and K2 are launched through raw ``ctypes`` launchers that no exported
graph contains. ``torch.export``, FakeTensor and the meta device all stop
at such data-dependent reads. So the port *runs* each entry at the
audit's small shape under a ``Recorder``, which sees every operation:

- **Host reads** (I1, the JAX ``callback_sites``): in a
  ``TorchFunctionMode``, ``item``, ``__bool__``, ``__int__``,
  ``__float__``, ``__index__``, ``tolist``, ``numpy`` and ``__array__``
  of a tensor on the recorded device, and ``cpu``/``to`` when they bring
  a tensor of a non-CPU recorded device to the CPU; and every call of
  ``torch.cuda.synchronize``, which no mode sees, so the recorder wraps
  the function for its window and puts it back after. A
  ``TorchDispatchMode`` on a CPU tensor sees only
  ``aten._local_scalar_dense`` and ``aten._to_copy`` of these, and
  ``tolist``, ``numpy`` and ``cpu`` never reach the dispatcher, so the
  reads are counted at the function level, where the census of a site is
  the same on the CPU and on ``cuda``. Each read is charged to its site:
  the first frame inside this package that is not the recorder (module,
  function, line), else the first frame outside torch. Reads the recorder
  cannot see: the implicit synchronizations of ops whose output size
  depends on the data (``nonzero``, boolean-mask indexing).
- **Nondeterminism** (I2): (a) any random aten op (``RANDOM_OPS``): the
  port draws its bits from its own threefry (``rng.py``), so any such op
  is a finding; (b) on ``cuda`` only, each op PyTorch itself flags: the
  run goes under ``torch.use_deterministic_algorithms(True,
  warn_only=True)`` and each warning becomes a record named by its op;
  both flags are put back after. PyTorch warns at every call of such an
  op (``put_``, flagged on every device, warns twice for two calls),
  and the recorder's filter (``always``) keeps each one. Deterministic
  mode also switches some CUDA ops to their deterministic
  implementations (``index_add_``, ``scatter_add_``, ``index_put_`` with
  accumulation), fills fresh ``torch.empty`` memory
  (``torch.utils.deterministic.fill_uninitialized_memory``) and asks
  cuBLAS for a fixed ``CUBLAS_WORKSPACE_CONFIG`` (a warning named
  ``cublas`` here). None of it changes what the port computes: on the
  card the recorded whole-grid run's scores and SHAP values equal a bare
  run's bit for bit, and no op of the port's paths raised a warning
  (``measure_audit.py``, ``chip_smoke.py``'s ``audit_path``), so no
  entry reads uninitialized memory either.
- **Wide dtypes** (I2's promotion check): every ``float64`` or
  ``complex128`` output of an aten op, charged to its site by the same
  frame walk, which runs only for a wide output, so the check costs one
  dtype comparison an output. ``int64`` is not wide here, where the JAX
  package's ``_WIDE_DTYPES`` lists it: it is PyTorch's index dtype, and
  ``argsort``, ``nonzero`` and the index operands of ``gather`` all
  produce it.
- **Memory envelope** (I4): every output of every aten op on the
  recorded device, keyed by its storage's ``data_ptr()``, so views count
  once. A storage is live from its first output until a
  weak reference to its ``untyped_storage()`` calls back, which happens
  when the storage is freed, not when a Python wrapper is dropped. A
  window's ``arg_bytes`` are the bytes live when it opens (an entry's
  tensor arguments are entered first), ``peak_bytes`` the largest live
  total inside it and ``out_bytes`` the bytes it made that are still
  live when it closes. This is a *measured* peak of live tensors at the
  audit's shape, not the JAX package's upper bound over a jaxpr. On
  ``cuda`` the allocator's own peak over the same window
  (``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``)
  stands beside it: the allocator rounds blocks up, and what the kernels'
  libraries allocate is invisible to the recorder, so the allocator's
  peak is at least the recorder's.
- **Kernel launches**: the change of ``kernels/hist.cum_hists.launches``
  (K1) and ``kernels/treeshap_unit.unit_shap.launches`` (K2) across the
  window. The raw launchers never reach the dispatcher, so the counts are
  the only record.

A recording is cut into windows, one an entry. ``trace_entry`` runs one
entry in one window. The plan executors (``SweepEngine.run_grid`` with
``planner_mode=True`` and ``pipeline.shap_grid``) are recorded whole and
cut at their own ``scores.plan`` and ``shap.plan`` spans: the recorder
wraps ``obs.span`` for the recording, and the number of windows each span
opened is the runtime census the audit holds against the planner's.
Modes are thread-local: a thread the entry starts (the guard's watchdog
under ``F16_FAULT_ENVELOPE_S``) runs unrecorded.

Import contract: this module imports torch at module level, so only the
audit's entry points import it, lazily (``analysis/rules_ir.py``,
``analysis/cli.py``'s ``audit`` and ``lint --ir``); nothing else under
``analysis/`` imports torch at load.
"""

import contextlib
import functools
import io
import os
import sys
import time
import warnings
import weakref

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from flake16_framework_tpu_torch import config as cfg, obs
from flake16_framework_tpu_torch.device import resolve
from flake16_framework_tpu_torch.kernels.build import launch_counts

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))
_STDLIB = os.path.dirname(os.path.abspath(contextlib.__file__))
_SELF = os.path.abspath(__file__)

# Tensor methods that hand a device value to the host (counted when the
# tensor lies on the recorded device), and the moves that do when they
# take a tensor of a non-CPU recorded device to the CPU.
HOST_READS = ("item", "__bool__", "__int__", "__float__", "__index__",
              "tolist", "numpy", "__array__")
HOST_MOVES = ("cpu", "to")
_HOST_FUNCS = {getattr(torch.Tensor, n): (n, n in HOST_MOVES)
               for n in HOST_READS + HOST_MOVES}

# Random aten ops (by overload packet): the port draws every random bit
# from its own threefry (rng.py), so any of these is a finding.
RANDOM_OPS = frozenset({
    "rand", "rand_like", "randint", "randint_like", "randn", "randn_like",
    "randperm", "bernoulli", "bernoulli_", "multinomial", "normal",
    "normal_", "uniform", "uniform_", "exponential", "exponential_",
    "random", "random_", "cauchy", "cauchy_", "log_normal",
    "log_normal_", "geometric", "geometric_", "poisson", "rrelu",
    "rrelu_with_noise", "native_dropout", "_fused_dropout",
    "_standard_gamma", "_sample_dirichlet", "binomial",
})
WIDE_DTYPES = (torch.float64, torch.complex128)

# The spans at which a recorded executor run is cut into plan windows
# (named by ``plan_entry``).
PLAN_SPANS = ("scores.plan", "shap.plan")

_DETERMINISM_MARKS = ("does not have a deterministic implementation",
                      "CUBLAS_WORKSPACE_CONFIG")


def plan_entry(span_name, key):
    """The audit's entry name of one plan window, as the JAX audit names
    its traced programs: ``scores.plan_batch[FS/Model]``, and for the
    SHAP arm ``shap.plan_batch[FS/Model]`` (path mode) or
    ``shap.plan_batch.<mode>[FS/Model]``."""
    family = f"[{key[0]}/{key[1]}]"
    if span_name == "scores.plan":
        return "scores.plan_batch" + family
    mode = key[2]
    return ("shap.plan_batch" if mode == "path"
            else f"shap.plan_batch.{mode}") + family


def _tensors(obj):
    """The tensors inside nested tuples, lists and dicts (NamedTuples
    included) and in the slots of an object that has ``__slots__`` (a
    registered model)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)
    else:
        slots = getattr(type(obj), "__slots__", ())
        for name in (slots,) if isinstance(slots, str) else slots:
            yield from _tensors(getattr(obj, name, None))


@functools.lru_cache(maxsize=4096)
def _kind(filename):
    """"pkg" for this package's files but the recorder, "skip" for the
    recorder, torch and the standard library, else "other"."""
    path = os.path.abspath(filename)
    if path == _SELF or filename.startswith("<") or path.startswith(
            (_TORCH + os.sep, _STDLIB + os.sep)):
        return "skip"
    return "pkg" if path.startswith(_PKG + os.sep) else "other"


def site_of(frame):
    """(path from the repo root, function, line) of the first frame from
    ``frame`` outward inside this package that is not the recorder, else
    of the first frame outside torch, the standard library and the
    recorder, else ("<unknown>", "", 0)."""
    other = None
    f = frame
    while f is not None:
        kind = _kind(f.f_code.co_filename)
        if kind == "pkg":
            return (os.path.relpath(f.f_code.co_filename, _ROOT)
                    .replace(os.sep, "/"), f.f_code.co_name, f.f_lineno)
        if kind == "other" and other is None:
            other = f
        f = f.f_back
    if other is None:
        return ("<unknown>", "", 0)
    return (os.path.relpath(other.f_code.co_filename, _ROOT)
            .replace(os.sep, "/"), other.f_code.co_name, other.f_lineno)


def site_str(site):
    """``path:line (function)``: how a site prints and keys a record."""
    return f"{site[0]}:{site[2]} ({site[1]})"


class _Window:
    """One entry's record while it is open; ``as_record`` when closed."""

    def __init__(self, entry, serial):
        self.entry = entry
        self.serial = serial
        self.host_reads = {}
        self.nondet = {}
        self.wide = {}
        self.arg_bytes = self.peak_bytes = self.out_bytes = 0
        self.allocator_peak_bytes = None
        self.launches0 = launch_counts()
        self.ops0 = 0
        self.t0 = time.perf_counter()

    def as_record(self, n_ops):
        counts = launch_counts()
        return {
            "entry": self.entry,
            "host_reads": dict(sorted(self.host_reads.items())),
            "nondet": dict(sorted(self.nondet.items())),
            "wide": dict(sorted(self.wide.items())),
            "arg_bytes": int(self.arg_bytes),
            "out_bytes": int(self.out_bytes),
            "peak_bytes": int(self.peak_bytes),
            "allocator_peak_bytes": self.allocator_peak_bytes,
            "k1_launches": counts["k1_launches"]
            - self.launches0["k1_launches"],
            "k2_launches": counts["k2_launches"]
            - self.launches0["k2_launches"],
            "aten_ops": n_ops - self.ops0,
            "wall_s": round(time.perf_counter() - self.t0, 4),
        }


class _FunctionMode(TorchFunctionMode):
    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        host = _HOST_FUNCS.get(func)
        if host is None:
            return func(*args, **kwargs)
        rec = self.rec
        if not host[1]:
            if args[0].device.type == rec.device_type:
                rec.host_read(host[0], sys._getframe(1))
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if rec.device_type != "cpu" and isinstance(out, torch.Tensor) and \
                out.device.type == "cpu" and \
                args[0].device.type == rec.device_type:
            rec.host_read(host[0], sys._getframe(1))
        return out


class _DispatchMode(TorchDispatchMode):
    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    @classmethod
    def _should_skip_dynamo(cls):
        # TorchDispatchMode wraps ``__torch_dispatch__`` to keep Dynamo out
        # of it; the port compiles nothing, and the wrapper is about a
        # fifth of the mode's cost an aten op.
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rec = self.rec
        rec.n_ops += 1
        # Keyed by id: an OpOverload hashes in Python, and each one lives
        # as long as the process.
        op = rec.ops.get(id(func))
        if op is None:
            name = func.overloadpacket.__name__
            op = rec.ops[id(func)] = (name, name in RANDOM_OPS)
        if op[1]:
            rec.nondet(op[0], sys._getframe(1))
        if isinstance(out, torch.Tensor):
            rec.output(out, op[0])
        elif isinstance(out, (tuple, list)):
            for o in out:
                if isinstance(o, torch.Tensor):
                    rec.output(o, op[0])
        return out


class _Live(weakref.ref):
    """A weak reference to one recorded storage; its callback runs when
    the storage is freed."""

    __slots__ = ("ptr", "nbytes", "window")


class Recorder:
    """Records everything the code between ``__enter__`` and ``__exit__``
    does on ``device``, cut into windows (``window``, or the plan spans
    with ``cut_plans``). ``records`` holds the closed windows' records in
    order, ``census`` the windows each plan span opened, ``n_ops`` the
    aten ops seen. Not reentrant, one window open at a time."""

    def __init__(self, device, *, cut_plans=False):
        self.device = torch.device(device)
        self.device_type = self.device.type
        self.cut_plans = cut_plans
        self.records = []
        self.census = {name: 0 for name in PLAN_SPANS}
        self.n_ops = 0
        self.ops = {}          # id(OpOverload) -> (name, random)
        self._win = None
        self._serial = 0
        self._live = {}        # data_ptr -> _Live
        self._cur = 0
        self._stack = None

    # -- events ----------------------------------------------------------

    def host_read(self, what, frame):
        w = self._win
        if w is not None:
            key = site_str(site_of(frame))
            w.host_reads[key] = w.host_reads.get(key, 0) + 1

    def nondet(self, op, frame):
        w = self._win
        if w is not None:
            key = f"{op} @ {site_str(site_of(frame))}"
            w.nondet[key] = w.nondet.get(key, 0) + 1

    def output(self, t, op):
        if t.dtype in WIDE_DTYPES and self._win is not None:
            key = (f"{op}:{str(t.dtype).removeprefix('torch.')} @ "
                   f"{site_str(site_of(sys._getframe(1)))}")
            self._win.wide[key] = self._win.wide.get(key, 0) + 1
        # A view's storage entered the live set with the op that made it.
        if not t._is_view() and t.device.type == self.device_type:
            self.track(t)

    def track(self, t):
        """Enter ``t``'s storage into the live set (once)."""
        st = t.untyped_storage()
        ptr = st.data_ptr()
        if not ptr or ptr in self._live:
            return
        nb = st.nbytes()
        if not nb:
            return
        ref = _Live(st, self._freed)
        ref.ptr, ref.nbytes = ptr, nb
        w = self._win
        ref.window = w.serial if w is not None else 0
        self._live[ptr] = ref
        self._cur += nb
        if w is not None and self._cur > w.peak_bytes:
            w.peak_bytes = self._cur

    def _freed(self, ref):
        if self._live.get(ref.ptr) is ref:
            del self._live[ref.ptr]
            self._cur -= ref.nbytes

    def _warning(self, message, category, filename, lineno, file=None,
                 line=None):
        text = str(message)
        if not any(m in text for m in _DETERMINISM_MARKS):
            self._showwarning(message, category, filename, lineno, file,
                              line)
            return
        # "<op> [with ...] does not have a deterministic implementation"
        op = "cublas" if "CUBLAS_WORKSPACE_CONFIG" in text else \
            text.split()[0]
        self.nondet(op, sys._getframe(1))

    # -- windows ---------------------------------------------------------

    @contextlib.contextmanager
    def window(self, entry, args=()):
        """Record one entry: ``args`` (tensors, nested) are entered into
        the live set first, as the entry's arguments."""
        if self._win is not None:
            raise RuntimeError(f"window {entry!r} opened inside "
                               f"{self._win.entry!r}")
        self._serial += 1
        w = _Window(entry, self._serial)
        for t in _tensors(args):
            if t.device.type == self.device_type:
                self.track(t)
        w.arg_bytes = w.peak_bytes = self._cur
        if self.device_type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        w.ops0 = self.n_ops
        self._win = w
        try:
            yield w
        finally:
            self._win = None
            w.out_bytes = sum(ref.nbytes for ref in self._live.values()
                              if ref.window == w.serial)
            if self.device_type == "cuda":
                w.allocator_peak_bytes = int(
                    torch.cuda.max_memory_allocated(self.device))
            self.records.append(w.as_record(self.n_ops))

    def _span(self, name, key=None, counts=None, **fields):
        inner = self._orig_span(name, key, counts, **fields)
        if name not in PLAN_SPANS:
            return inner
        self.census[name] += 1
        return self._plan_window(plan_entry(name, key), inner)

    @contextlib.contextmanager
    def _plan_window(self, entry, inner):
        with self.window(entry):
            with inner as sp:
                yield sp

    # -- the recording -----------------------------------------------------

    def _synchronize(self, *args, **kwargs):
        self.host_read("synchronize", sys._getframe(1))
        return self._orig_sync(*args, **kwargs)

    def __enter__(self):
        stack = contextlib.ExitStack()
        try:
            self._orig_sync = torch.cuda.synchronize
            torch.cuda.synchronize = self._synchronize
            stack.callback(setattr, torch.cuda, "synchronize",
                           self._orig_sync)
            if self.cut_plans:
                self._orig_span = obs.span
                obs.span = self._span
                stack.callback(setattr, obs, "span", self._orig_span)
            if self.device_type == "cuda":
                stack.enter_context(warnings.catch_warnings())
                for mark in _DETERMINISM_MARKS:
                    warnings.filterwarnings("always", message="(?s).*" + mark)
                self._showwarning = warnings.showwarning
                warnings.showwarning = self._warning
                prev = (torch.are_deterministic_algorithms_enabled(),
                        torch.is_deterministic_algorithms_warn_only_enabled())
                torch.use_deterministic_algorithms(True, warn_only=True)
                stack.callback(lambda: torch.use_deterministic_algorithms(
                    prev[0], warn_only=prev[1]))
            stack.enter_context(_FunctionMode(self))
            stack.enter_context(_DispatchMode(self))
        except BaseException:
            stack.close()
            raise
        self._stack = stack
        return self

    def __exit__(self, *exc):
        self._stack.close()
        self._stack = None
        self._live.clear()  # a dropped reference calls back no more
        self._cur = 0
        return False


# -- entry points ------------------------------------------------------------


def _device_of(args, kwargs):
    for t in _tensors((args, kwargs or {})):
        return t.device
    return resolve(None)


def trace_entry(fn, args, kwargs=None, *, entry="entry", device=None):
    """Run ``fn(*args, **kwargs)`` once under a ``Recorder`` in one
    window; returns (record, result). The device is ``device``, else the
    first tensor argument's, else ``cuda``."""
    dev = torch.device(device) if device is not None else \
        _device_of(args, kwargs)
    with Recorder(dev) as rec:
        with rec.window(entry, (args, kwargs or {})):
            out = fn(*args, **(kwargs or {}))
    return rec.records[0], out


AUDIT_SEED = 0
AUDIT_PROJECTS = 26


def audit_data(n, n_projects=AUDIT_PROJECTS, seed=AUDIT_SEED):
    """(features, labels, project names a row, the project names,
    project ids): the synthetic dataset (``utils/synth.make_dataset``) at
    ``n`` rows that every audit entry runs on."""
    from flake16_framework_tpu_torch.utils.synth import make_dataset

    feats, labels, pids = make_dataset(n_tests=n, n_projects=n_projects,
                                       seed=seed)
    names = [f"project{p:02d}" for p in range(n_projects)]
    projects = np.array([names[p] for p in pids])
    return feats, labels, projects, names, pids


def trace_plan_program(configs, data, *, device, max_depth=8,
                       tree_overrides=None):
    """The scores arm: ``SweepEngine(..., planner_mode=True).run_grid``
    over ``configs`` on ``data`` (``audit_data``), recorded whole and cut
    at its ``scores.plan`` spans, with no budget pre-flight: the audit
    holds ``F16_DEVICE_BUDGET_MB`` against the recorded peaks (I401).
    Returns (records, plan windows opened, {config keys: result})."""
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    with Recorder(device, cut_plans=True) as rec:
        engine = SweepEngine(*data, max_depth=max_depth,
                             tree_overrides=tree_overrides, device=device,
                             planner_mode=True, preflight=False)
        scores = engine.run_grid(configs)
    if engine.quarantined:
        raise RuntimeError(f"audit: configs quarantined "
                           f"{sorted(engine.quarantined)}")
    return rec.records, rec.census["scores.plan"], scores


def trace_shap_plan_program(configs, data, *, device, mode="path",
                            n_explain=16, n_background=8, max_depth=8,
                            tree_overrides=None):
    """The SHAP arm: ``pipeline.shap_grid`` over ``configs`` in ``mode``,
    recorded whole and cut at its ``shap.plan`` spans. Returns (records,
    plan windows opened, {config: values})."""
    from flake16_framework_tpu_torch import pipeline

    with Recorder(device, cut_plans=True) as rec:
        values = pipeline.shap_grid(
            mode=mode, n_explain=n_explain, n_background=n_background,
            max_depth=max_depth, tree_overrides=tree_overrides,
            configs=configs, arrays=data[:2], device=device,
            progress_out=io.StringIO())
    return rec.records, rec.census["shap.plan"], values


def shap_kernel_entries(data, *, device, n_trees=2, depth=8, n_samples=32,
                        n_background=8):
    """{entry: (fn, args, kwargs)} for the SHAP engines of
    ``ops/treeshap.py`` on one small real forest (the first SHAP config,
    fit on ``data`` at ``n_trees`` trees and depth ``depth``):
    ``shap.path`` (the single-bucket unit engine, one K2 launch),
    ``shap.interventional`` and ``shap.interactions``."""
    from flake16_framework_tpu_torch import pipeline
    from flake16_framework_tpu_torch.ops import treeshap

    keys = cfg.SHAP_CONFIGS[0]
    xp, _, _, forest = pipeline.fit_shap_model(
        keys, data[0], data[1], max_depth=depth,
        tree_overrides={keys[4]: n_trees}, device=device)
    x = xp[:n_samples].contiguous()
    bg = xp[:n_background].contiguous()
    return {
        "shap.path": (treeshap.forest_shap_graph, (forest, x), {}),
        "shap.interventional": (treeshap.forest_shap_interventional,
                                (forest, x, bg), {}),
        "shap.interactions": (treeshap.forest_shap_interactions,
                              (forest, x), {}),
    }
