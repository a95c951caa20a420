"""flake16_framework_tpu_torch: the Flake16 ML pipeline in PyTorch and CUDA
for one NVIDIA H100, beside the JAX package ``flake16_framework_tpu``.

It imports torch and numpy, never jax and nothing of the JAX package: it
keeps its own copies of what it needs of it (the grid, the loader, the
fold masks, the planner, the figures, the synthetic dataset). Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``. Two hand-written
CUDA kernels carry the device work: the histogram step of the tree grower
(``csrc/hist_cumsum.cu``) and the path-dependent Tree SHAP unit
(``csrc/treeshap_unit.cu``).

The verbs (``__main__``): ``scores`` (all 216 configs; ``lopo``,
``planner``, ``fused``, ``dispatch=N``), ``resume``, ``shap`` (the paper's
two configs, or ``grid|interventional|interaction`` over the whole grid),
``figures``, ``serve`` (the scoring service in one process, or a fleet
of worker processes behind a router, ``serve/``), ``report``, ``trace``
and ``perf``. ``obs/`` holds the telemetry: the event sink, the flight
ring, the SLO monitor, the performance database, the metrics exporter
and the lock-order witness.
"""

# obs first: with F16_LOCKWATCH set it arms the lock-order witness, which
# has to patch the lock factories before any module of the package
# creates a lock at import time (kernels/build.COUNT_LOCK, obs/core).
from flake16_framework_tpu_torch import obs as _obs  # noqa: F401

__version__ = "0.1.0"
