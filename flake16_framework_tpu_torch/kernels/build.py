"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles, on its own, to a shared library with a
plain C interface for ``sm_90a`` (Hopper), which ``ctypes`` loads. The
library's file name carries a hash of its source, so an edited source
rebuilds and an unchanged one is reused. Build outputs go to ``_build/``
inside the package directory (ignored by git).

The build cache's traffic is counted: a hit is a library already under
its hashed name, a miss a run of ``nvcc``, each with the wall of the
build (``cache_stats``; the counterpart of the JAX package's listener on
XLA's persistent compilation cache). Each wrapper counts its launches
through ``count_launch``, which also feeds the kernel's analytic work to
an open counting pass (``obs/costs.py``) and, inside a CUDA graph
capture (``obs/aot.py``), records the launch in the capture's tally in
place of the count: a captured kernel runs at each replay, not at the
capture.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}

# Held by each wrapper around the increment of its ``launches`` count,
# which the scoring service's dispatcher threads reach concurrently.
COUNT_LOCK = threading.Lock()
# Held around a library's first load, which the sweep's card workers can
# reach together: one build a library.
_LOAD_LOCK = threading.Lock()

# The build cache's traffic since process start: hits, misses and the
# wall of the builds and loads, in seconds.
_CACHE = {"hits": 0, "misses": 0, "build_s": 0.0}
_CACHE_LOCK = threading.Lock()

# Per thread: ``tally`` ({wrapper: launches}) while a graph capture is
# open, ``passes`` (the counting passes open, innermost last), ``builds``
# (build-cache traffic noted and not yet charged).
_local = threading.local()


def cache_stats():
    """{"hits", "misses", "build_s"}: the build cache's traffic in this
    process."""
    with _CACHE_LOCK:
        return dict(_CACHE)


@contextlib.contextmanager
def counting(pass_):
    """Open ``pass_`` (an object with ``kernel(work)`` and an attribute
    ``compile_s``) on this thread for the block: every launch counted
    here adds its work to it, every build or load its wall."""
    passes = getattr(_local, "passes", None)
    if passes is None:
        passes = _local.passes = []
    passes.append(pass_)
    try:
        yield pass_
    finally:
        passes.remove(pass_)


@contextlib.contextmanager
def capture_tally():
    """For the block, this thread's launches are a graph capture's: each
    goes into the yielded {wrapper: launches} and not into the wrapper's
    count."""
    prev = getattr(_local, "tally", None)
    _local.tally = tally = {}
    try:
        yield tally
    finally:
        _local.tally = prev


def capturing():
    """Whether this thread is inside ``capture_tally``."""
    return getattr(_local, "tally", None) is not None


def count_launch(wrapper, work=None):
    """Count one launch of ``wrapper``'s kernel in ``wrapper.launches``,
    or, inside a capture, in the capture's tally. ``work`` (a callable
    returning the kernel's {"flops", "bytes"}) is called only while a
    counting pass is open on this thread, and never in a capture."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    with COUNT_LOCK:
        wrapper.launches += 1
    passes = getattr(_local, "passes", None)
    if passes and work is not None:
        passes[-1].kernel(work)


def add_launches(tally):
    """Add a capture's tally to the wrappers' counts: one replay's
    launches."""
    with COUNT_LOCK:
        for wrapper, n in tally.items():
            wrapper.launches += n


def launch_counts():
    """K1's and K2's launches so far in this process, as the span fields
    ``k1_launches`` and ``k2_launches`` (``obs.span(counts=...)``)."""
    from flake16_framework_tpu_torch.kernels.hist import cum_hists
    from flake16_framework_tpu_torch.kernels.treeshap_unit import unit_shap

    return {"k1_launches": cum_hists.launches,
            "k2_launches": unit_shap.launches}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    nvcc = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return nvcc


def _lib_path(name):
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names):
    """Compile each ``csrc/<name>.cu`` that is not built yet, one ``nvcc``
    a source, all started together. Returns {name: the compiler's output
    (register, shared-memory and spill report)}, kept beside the library
    and read back when the library is reused. Waits for every compiler
    before it raises on a failure."""
    try:
        return _build(names)
    finally:
        _charge()


def _build(names):
    """``build``, with its cache traffic noted on this thread for
    ``_charge`` (``load`` charges it once its lock is released)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    started = {}
    logs = {}
    hits = 0
    for name in names:
        out = _lib_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
            hits += 1
            continue
        if name in started:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in started.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit "
                          f"{proc.returncode}):\n{logs[name]}")
        else:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)
    _note_build(time.perf_counter() - t0, hits=hits, misses=len(started))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def _note_build(wall_s, hits=0, misses=0):
    """Note build-cache traffic on this thread, for ``_charge``."""
    t = getattr(_local, "builds", None) or [0.0, 0, 0]
    _local.builds = [t[0] + wall_s, t[1] + hits, t[2] + misses]


def _charge():
    """Count this thread's noted build-cache traffic, and charge its wall
    to the thread's open counting passes. Takes ``_CACHE_LOCK`` alone,
    never under another lock."""
    t = getattr(_local, "builds", None)
    if t is None:
        return
    _local.builds = None
    with _CACHE_LOCK:
        _CACHE["build_s"] += t[0]
        _CACHE["hits"] += t[1]
        _CACHE["misses"] += t[2]
    for p in getattr(_local, "passes", None) or ():
        p.compile_s += t[0]


def load(name):
    """The ctypes handle of kernel library ``name``, built if needed."""
    try:
        with _LOAD_LOCK:
            if name not in _loaded:
                _build((name,))
                t0 = time.perf_counter()
                _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
                _note_build(time.perf_counter() - t0)
            return _loaded[name]
    finally:
        _charge()
