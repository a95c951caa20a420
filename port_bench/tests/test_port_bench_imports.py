"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program: checked in a fresh interpreter,
by whole top-level module names (the port's name begins with the JAX
package's)."""

import json
import os
import subprocess
import sys

from port_bench import run
from port_bench.tests import tiny

PROBE = r"""
import glob, json, os, sys
sys.path.insert(0, {root!r})
import port_bench.run, port_bench.limits
from port_bench.harness import spec
for sub in ("harness", "reference"):
    for p in sorted(glob.glob(os.path.join({root!r}, "port_bench", sub,
                                           "*.py"))):
        name = os.path.basename(p)[:-3]
        if name != "__init__":
            __import__(f"port_bench.{{sub}}.{{name}}")
for kind in ("traffic", "metrics"):
    for p in sorted(glob.glob(os.path.join({root!r}, "port_bench", kind,
                                           "*.py"))):
        name = os.path.basename(p)[:-3]
        if name != "__init__":
            spec.load_module(kind, name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=tiny.ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_harness_module_loads_jax_or_the_jax_package():
    top = _loaded()
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)
    # The reference, the metrics and the drivers load the program only
    # inside a run's set-up.
    assert "flake16_framework_tpu_torch" not in top


def test_the_guard_compares_whole_top_level_names():
    assert run.forbidden_modules(["flake16_framework_tpu_torch.ops",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "flake16_framework_tpu.ops",
                                  "flax"]) == ["flake16_framework_tpu.ops",
                                               "flax", "jax.numpy"]
