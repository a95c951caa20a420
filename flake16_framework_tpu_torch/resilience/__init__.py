"""resilience — crash tolerance of the ``scores`` verb (a copy of the JAX
package's layer, for CUDA):

- faults.py      — the fault classifier ({transient-device, oom,
                   deterministic, envelope-overrun, relay-down}), with the
                   CUDA runtime's errors
- guard.py       — the dispatch guard: device synchronisation, optional
                   watchdog deadline, retries with exponential backoff +
                   jitter
- inject.py      — F16_FAULT_INJECT: deterministic fault injection, device
                   classes and the process classes sigkill/sigterm
- quarantine.py  — the per-config quarantine sidecar + exit code 23
- journal.py     — the write-ahead sweep journal: fold-granular, fsync'd,
                   checksummed resume state, byte-compatible with the JAX
                   package's
- supervisor.py  — restart-budgeted child supervision for the kill drill

No module here imports torch: a fault can only be one of torch's types
where torch is already loaded.
"""

from flake16_framework_tpu_torch.resilience import (  # noqa: F401
    faults, guard, inject, journal, quarantine, supervisor,
)
from flake16_framework_tpu_torch.resilience.faults import (  # noqa: F401
    DETERMINISTIC, ENVELOPE_OVERRUN, FAULT_CLASSES, OOM, RELAY_DOWN,
    RETRYABLE, TRANSIENT_DEVICE, classify, classify_message,
)
from flake16_framework_tpu_torch.resilience.guard import (  # noqa: F401
    BackoffPolicy, DispatchAbandoned, DispatchGuard, default_guard,
    policy_from_env,
)
from flake16_framework_tpu_torch.resilience.inject import (  # noqa: F401
    InjectedFault, parse_plan, plan_from_env, strip_process_entries,
)
from flake16_framework_tpu_torch.resilience.journal import (  # noqa: F401
    JournalLock, JournalLocked, SweepJournal, journal_path,
)
from flake16_framework_tpu_torch.resilience.quarantine import (  # noqa: F401
    QUARANTINE_EXIT_CODE, QuarantinedConfigs,
)
from flake16_framework_tpu_torch.resilience.supervisor import (  # noqa: F401
    RestartBudgetExceeded, supervise,
)
