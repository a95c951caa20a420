"""Restart-budgeted child supervision (a copy of the JAX package's).

A SIGKILL can land between any two instructions. The write-ahead journal
(resilience/journal.py) makes the on-disk state resumable; this module
closes the loop by RESTARTING the killed process, so a sweep survives
preemption unattended:

    rc, history = supervise([sys.executable, "-m",
                             "flake16_framework_tpu_torch", "scores"])

Policy — deliberately narrow:

- a child that EXITS (rc >= 0, zero or not) is a completed run: its
  exit code is the caller's to interpret (e.g. the quarantine exit 23),
  never ours to retry;
- a child KILLED BY A SIGNAL (rc < 0) is restarted with the same argv —
  the resume path is the child's own (journal replay for ``scores``) —
  up to ``max_restarts`` times, after which ``RestartBudgetExceeded``
  carries the full death history;
- before each restart the dead child's flight ring (``F16_FLIGHT`` naming
  a path the parent can see) is dumped, and a ``restart`` event is
  emitted, so ``report`` and ``trace`` show the run's preemptions next to
  its faults.

Kill drill: when the environment carries ``F16_FAULT_INJECT`` process
entries (``<config>:<fold>:sigkill`` — inject.py), the FIRST child
inherits them (the journal delivers the signal at its deterministic
fold-append point) and every RESTARTED child gets the plan with process
entries stripped, so each injected kill fires exactly once and the
restarted run completes.
"""

import os
import subprocess
import sys
import time

from flake16_framework_tpu_torch import obs
from flake16_framework_tpu_torch.resilience import inject


class RestartBudgetExceeded(RuntimeError):
    """The child died by signal more times than the budget allows.
    ``history`` holds one dict per death ({"rc", "signal", "wall_s"})."""

    def __init__(self, message, history):
        super().__init__(message)
        self.history = history


def supervise(argv, *, max_restarts=3, env=None, cwd=None, backoff_s=0.0,
              stdout=None, stderr=None, warn_out=sys.stderr,
              strip_chaos_on_restart=True):
    """Run ``argv`` to completion, restarting signal deaths (see module
    docstring). Returns ``(rc, history)`` where ``rc`` is the final
    child's exit code (>= 0) and ``history`` the signal deaths absorbed
    along the way. Raises RestartBudgetExceeded past the budget.
    ``backoff_s`` is the wait before each restart; with
    ``strip_chaos_on_restart=False`` a restarted child keeps the
    injection plan's process entries (they fire again)."""
    base_env = dict(os.environ if env is None else env)
    history = []
    attempt = 0
    while True:
        child_env = dict(base_env)
        if attempt > 0 and strip_chaos_on_restart:
            spec = child_env.get(inject.ENV_VAR, "")
            if spec:
                stripped = inject.strip_process_entries(spec)
                if stripped:
                    child_env[inject.ENV_VAR] = stripped
                else:
                    child_env.pop(inject.ENV_VAR, None)
        t0 = time.time()
        proc = subprocess.run(argv, env=child_env, cwd=cwd,
                              stdout=stdout, stderr=stderr)
        rc = proc.returncode
        if rc >= 0:
            return rc, history
        history.append({"rc": rc, "signal": -rc,
                        "wall_s": round(time.time() - t0, 3)})
        _dump_flight(base_env, warn_out)
        attempt += 1
        if attempt > max_restarts:
            raise RestartBudgetExceeded(
                f"child killed by signal {-rc}; restart budget "
                f"({max_restarts}) exhausted after {len(history)} "
                f"death(s)", history)
        obs.event("restart", attempt=attempt, rc=rc, budget=max_restarts,
                  label=os.path.basename(str(argv[0] if argv else "?")))
        if warn_out is not None:
            warn_out.write(
                f"supervisor: child killed by signal {-rc}; restart "
                f"{attempt}/{max_restarts} with resume\n")
        if backoff_s:
            time.sleep(backoff_s)


def _dump_flight(base_env, warn_out):
    """Dump the dead child's flight ring (obs/flight.py) before the
    restart overwrites it: replay the CRC-valid tail, print it, flush the
    gauges' last values into the child's run manifest. Only possible when
    ``F16_FLIGHT`` names a path the parent can see (the ``=1`` run-dir
    form is private to the child); never fatal, since the restart must
    go ahead whatever the ring holds."""
    from flake16_framework_tpu_torch.obs import flight

    path = flight.env_path(environ=base_env)
    if not path or not os.path.isfile(path):
        return
    try:
        flight.dump(path, out=warn_out)
    except (OSError, ValueError) as e:
        if warn_out is not None:
            warn_out.write(f"supervisor: flight dump failed: {e}\n")
