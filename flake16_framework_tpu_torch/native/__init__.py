"""Build and load the port's native host code at first use.

``load(name)`` compiles ``native/<name>.cc`` with the host compiler
(``g++``, CPython C API) into the package's ``_build/`` (ignored by git),
under a file name that carries a hash of the source, the flags and the
interpreter's extension suffix, so an edited source rebuilds and an
unchanged one is reused. The build is atomic: the compiler writes a temp
file unique to the process, which ``os.replace`` moves into place, so
processes that build at once (pytest-xdist workers, a sweep's children)
each load a whole module; a lock makes the threads of one process build
once.

A failed build or import raises ``NativeBuildError`` with the compiler's
output. There is no silent fallback to the Python bodies: a fast path
runs or raises. Imports no torch (the collation is torch-free).

Modules:
- ``collate_fast``: the collation's numbits decode and coverage feature
  sums (``runner/collate.py``).
- ``treeshap_cext``: the host C++ Tree SHAP baseline, shap 0.40's
  recursive EXTEND/UNWIND in f64 (``baseline.py``); no verb runs it.
"""

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared"]

_loaded = {}
# Held around a module's first build and import.
_LOAD_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    """The native module could not be built or imported."""


def _so_path(name):
    tag = " ".join([*CXX_FLAGS, sysconfig.get_config_var("EXT_SUFFIX") or ""])
    digest = hashlib.sha256((SRC_DIR / f"{name}.cc").read_bytes() +
                            tag.encode()).hexdigest()[:12]
    return BUILD_DIR / f"_{name}-{digest}.so"


def _compile_cmd(src, out):
    """The compiler's argv that builds ``src`` into ``out``."""
    include = sysconfig.get_paths()["include"]
    return ["g++", *CXX_FLAGS, f"-I{include}", str(src), "-o", str(out)]


def _build(name, out):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        cmd = _compile_cmd(SRC_DIR / f"{name}.cc", tmp)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(
                f"could not run the compiler for {name}.cc: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"{cmd[0]} failed on {name}.cc (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def load(name="collate_fast"):
    """The native module ``name``, built if needed; raises
    ``NativeBuildError`` when it cannot be built or imported."""
    mod = _loaded.get(name)
    if mod is not None:
        return mod
    with _LOAD_LOCK:
        if name not in _loaded:
            out = _so_path(name)
            if not out.exists():
                _build(name, out)
            spec = importlib.util.spec_from_file_location(
                f"{__name__}._{name}", out)
            mod = importlib.util.module_from_spec(spec)
            try:
                spec.loader.exec_module(mod)
            except ImportError as e:
                raise NativeBuildError(
                    f"could not import the built {out.name}: {e}") from e
            _loaded[name] = mod
        return _loaded[name]
