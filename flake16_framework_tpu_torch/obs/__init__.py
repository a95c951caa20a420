"""obs — the port's telemetry: spans, counters/gauges, the JSONL event
sink, run manifests, heartbeat (``core``), the crash-surviving flight
ring (``flight``) and the SLO monitor (``slo``), each in the JAX
package's formats (``schema``).

Off unless ``F16_TELEMETRY`` is set (``1`` or a root directory; the
command line reads it at its entry): every call here is then a single
``is None`` check, so instrumentation lives directly in the serving code
without a cost. The exporter, the lock-order witness, ``trace`` and
``report`` come with ROADMAP.md §A 6.
"""

from flake16_framework_tpu_torch.obs.core import (  # noqa: F401
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
    shutdown,
    span,
    start_heartbeat,
    stop_heartbeat,
)
