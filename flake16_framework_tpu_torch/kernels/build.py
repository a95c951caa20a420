"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles, on its own, to a shared library with a
plain C interface for ``sm_90a`` (Hopper), which ``ctypes`` loads. The
library's file name carries a hash of its source, so an edited source
rebuilds and an unchanged one is reused. Build outputs go to ``_build/``
inside the package directory (ignored by git).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    logs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
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
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name):
    """The ctypes handle of kernel library ``name``, built if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return _loaded[name]
