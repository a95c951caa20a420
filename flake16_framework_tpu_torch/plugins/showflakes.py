"""showflakes: per-test outcome recording for flakiness detection (a copy
of the JAX package's ``plugins/showflakes.py``).

Contract (consumed by runner/collate.ingest_runs_tsv):

- ``--record-file=<path>``: write one ``outcome\\tnodeid`` line per executed
  test, in execution order; any outcome containing the substring "failed"
  counts as a failure downstream.
- ``--shuffle``: run the collected tests in a fresh uniformly-random order
  (the order-dependent-flakiness probe; a new order every invocation).
- ``--set-exitstatus``: exit 0 when the run completed even if tests failed —
  failing tests are the *data* of a flakiness study, and the orchestrator
  (runner/containers.py) uses the exit status to mean "run completed", not
  "suite green". Collection/internal errors still exit nonzero.
"""

import os
import random

import pytest

_WORSE = {"passed": 0, "skipped": 1, "failed": 2}


def pytest_addoption(parser):
    group = parser.getgroup("showflakes")
    group.addoption("--record-file", action="store", default=None,
                    help="write per-test outcome TSV to this path")
    group.addoption("--shuffle", action="store_true", default=False,
                    help="run tests in a fresh random order")
    group.addoption("--set-exitstatus", action="store_true", default=False,
                    help="exit 0 when the run completed, even with failures")


@pytest.hookimpl(trylast=True)
def pytest_collection_modifyitems(config, items):
    # trylast: shuffle the final order, after every other plugin's reordering.
    # A PRIVATE Random instance: subject suites commonly call random.seed()
    # for reproducibility at conftest import, which would otherwise freeze
    # every "shuffled" run into one identical permutation and blind the
    # order-dependence probe. SHOWFLAKES_SEED is a testing hook.
    if config.getoption("--shuffle"):
        seed = os.environ.get("SHOWFLAKES_SEED")
        rng = random.Random(int(seed)) if seed else random.Random()
        rng.shuffle(items)


def pytest_configure(config):
    if config.getoption("--record-file") or config.getoption(
        "--set-exitstatus"
    ):
        config.pluginmanager.register(_ShowFlakes(config), "_showflakes_impl")


class _ShowFlakes:
    def __init__(self, config):
        self.record_file = config.getoption("--record-file")
        self.set_exitstatus = config.getoption("--set-exitstatus")
        self.outcomes = {}  # nodeid -> outcome, insertion = execution order

    def pytest_runtest_logreport(self, report):
        # A test's outcome is its worst phase: a setup/teardown error reports
        # outcome "failed" on that phase, so it lands as a failure too.
        prev = self.outcomes.get(report.nodeid, "passed")
        if _WORSE[report.outcome] > _WORSE[prev]:
            self.outcomes[report.nodeid] = report.outcome
        else:
            self.outcomes.setdefault(report.nodeid, prev)

    def pytest_sessionfinish(self, session, exitstatus):
        if self.record_file:
            # standalone plugin (runs inside subject venvs): no package
            # imports, so no utils.atomic_write here
            with open(self.record_file, "w") as fd:  # f16lint: disable=J701
                for nid, outcome in self.outcomes.items():
                    fd.write(f"{outcome}\t{nid}\n")
        if self.set_exitstatus and exitstatus == pytest.ExitCode.TESTS_FAILED:
            session.exitstatus = pytest.ExitCode.OK
