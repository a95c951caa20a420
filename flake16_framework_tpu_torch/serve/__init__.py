"""serve — the scoring service (the JAX package's ``serve/``), in one
process or as a fleet:

- ``registry``  — model registry keyed by trained-config artifact
  (config code + per-array shape signature), the sweep's scores ledger
  as the artifact source, and pickle persistence in the JAX package's
  schema (each package loads the other's registry);
- ``store``     — executable store: each model prepared once on the
  device (forest, mu, W, the single-bucket SHAP rows), warmed with one
  zero batch per (kind, bucket);
- ``queue``     — the bounded request queue (submit -> future);
- ``batcher``   — shape-bucketed microbatcher: pads coalesced requests
  to a bucket, dispatches through the dispatch guard with bounded
  in-flight batches, quarantine on an abandoned dispatch;
- ``service``   — ``ScoringService``: the in-process client API, p50/p99
  latency, and ``drain()`` (admission close, in-flight completion,
  retriable rejection of unstarted requests, durable-state flush with a
  deadline that escalates to checkpoint-and-abort);
- ``wire``      — the fleet's length-prefixed JSON frames (byte-equal
  to the JAX package's);
- ``fleet``     — the worker half (``WorkerServer``, ``worker_main``) and
  the manager (``Fleet``: spawn, ready, restart budget, flight dump);
- ``router``    — ``FleetRouter``: health gating, least-loaded pick,
  hedging, failover, rolling restart;
- ``cli``       — the ``serve`` verb (``--hold`` = the drain drill's
  child, ``--fleet W``, ``--worker`` = a fleet's child).

SHAP is answered on the Tree SHAP unit kernel (``csrc/treeshap_unit.cu``)
through ``ops.treeshap.graph_shap``; the RF and ET fits of the registry
run the histogram kernel. The metrics exporter comes with ROADMAP.md
§A 6.
"""

from flake16_framework_tpu_torch.serve.queue import (  # noqa: F401
    RequestQueue, RequestRejected, RetriableRejection, ScoreRequest,
    ServeError,
)
from flake16_framework_tpu_torch.serve.registry import (  # noqa: F401
    ModelRegistry, RegisteredModel, artifact_signature, configs_from_ledger,
    model_id_for,
)
from flake16_framework_tpu_torch.serve.store import ExecutableStore  # noqa: F401
from flake16_framework_tpu_torch.serve.batcher import Microbatcher  # noqa: F401
from flake16_framework_tpu_torch.serve.service import (  # noqa: F401
    LatencyStats, ScoringService,
)
