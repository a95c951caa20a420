"""obs — the port's telemetry: spans, counters/gauges, the JSONL event
sink, run manifests, heartbeat and the ``torch.profiler`` hook
(``core``), the crash-surviving flight ring (``flight``), the SLO
monitor (``slo``), the ``report`` and ``trace`` verbs that read a run
back (``report``, ``trace``), the performance database and the ``perf``
verb (``perfdb``, ``perf_diff``), the live metrics exporter
(``metrics``) and the lock-order witness (``lockwatch``), each in the
JAX package's formats (``schema``).

Off unless ``F16_TELEMETRY`` is set (``1`` or a root directory; the
command line reads it at its entry): every call here is then a single
``is None`` check, so instrumentation lives directly in the sweep, the
SHAP verbs, the resilience layer and the serving code without a cost.
The exporter is pull-based and costs nothing unless served; the witness
is armed only by ``F16_LOCKWATCH``.

A ``torch.profiler`` capture, whoever runs it (``profile=``,
``F16_XPROF`` or a caller's own), shows the program's spans and its
``region()`` stages (the grower's draws, K1, split scan and routing, the
sweep's prep, resample and counts, the service's collect, handoff and
dispatch legs) as ranges, on the clock of its kernels, telemetry on or
off, on the threads whose calls it records. On the others, and on every
thread under a ``profile_all_threads`` capture (which records all
threads but tells none that it does), they are only in
``thread_regions()``. A region never reaches the JSONL sink, so the sink
holds the JAX package's spans only.
"""

# The lock-order witness must arm BEFORE obs.core runs: core's
# module-level locks have to be minted by the patched factories for
# lockwatch to see them (no-op unless F16_LOCKWATCH). The package's
# ``__init__`` imports this module first, so every lock the port
# creates at import time is traced.
from flake16_framework_tpu_torch.obs import lockwatch as _lockwatch

_lockwatch.maybe_install_from_env()

from flake16_framework_tpu_torch.obs.core import (  # noqa: E402, F401
    Span,
    adopt_trace,
    append_jsonl,
    configure,
    configure_from_env,
    counter_add,
    current_run_dir,
    default_root,
    device_memory_peak_mb,
    emit_memory_gauges,
    enabled,
    event,
    gauge,
    host_rss_peak_mb,
    manifest_update,
    mint_trace,
    profiler_trace,
    record_device_manifest,
    region,
    shutdown,
    span,
    start_heartbeat,
    stop_heartbeat,
    thread_regions,
    xprof_trace,
)
