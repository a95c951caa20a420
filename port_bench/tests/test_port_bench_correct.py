"""How ``correct`` is decided, on the CPU at a size a test holds: the
plain reference agrees with the port, and a run whose timed path is
broken underneath (an answer altered where it is produced, half of the
batch left out with the mean taken over the rest, a request refused)
comes out not correct;
the control, the reference in bfloat16, fails the limits."""

import numpy as np
import pytest

from port_bench.tests import tiny

CELLS = ("study-scores-hist", "serve-ci-mixed", "serve-ci-predict")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(root, cell):
    out = tiny.execute(root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def _altered_counts(monkeypatch):
    from flake16_framework_tpu_torch.parallel import sweep

    real = sweep.confusion_by_fold

    def altered(*args, **kwargs):
        counts = real(*args, **kwargs).clone()
        counts[0, 0, 2] += 1                  # one true positive more
        return counts

    monkeypatch.setattr(sweep, "confusion_by_fold", altered)


def _half_the_trees_sweep(monkeypatch):
    from flake16_framework_tpu_torch.ops import trees

    real = trees.predict_batch

    def half(forest, x):
        k = forest.feature.shape[1] // 2
        return real(trees.Forest(*(f[:, :k] for f in forest[:-1]),
                                 forest.max_depth), x)

    monkeypatch.setattr(trees, "predict_batch", half)


def _altered_answer(monkeypatch):
    from flake16_framework_tpu_torch.serve import store

    real = store.ExecutableStore.call

    def altered(self, model, kind, x):
        out = real(self, model, kind, x).clone()
        out[0, 0] += 1e-3
        return out

    monkeypatch.setattr(store.ExecutableStore, "call", altered)


def _refused_request(monkeypatch):
    from flake16_framework_tpu_torch.serve import service
    from flake16_framework_tpu_torch.serve.queue import RequestRejected

    real = service.ScoringService.submit
    sent = []

    def refusing(self, *args, **kwargs):
        sent.append(1)
        if len(sent) == 3:
            raise RequestRejected("queue full (256 requests)")
        return real(self, *args, **kwargs)

    monkeypatch.setattr(service.ScoringService, "submit", refusing)


def _half_the_trees_serve(monkeypatch):
    from flake16_framework_tpu_torch.ops import trees

    real = trees.predict_proba

    def half(forest, x, impl=None, plans=None):
        k = max(1, forest.feature.shape[0] // 2)
        return real(trees.Forest(*(f[:k] for f in forest[:-1]),
                                 forest.max_depth), x, impl, plans)

    monkeypatch.setattr(trees, "predict_proba", half)


@pytest.mark.parametrize("cell,fault", [
    ("study-scores-hist", _altered_counts),
    ("study-scores-hist", _half_the_trees_sweep),
    ("serve-ci-mixed", _altered_answer),
    ("serve-ci-predict", _altered_answer),
    ("serve-ci-predict", _half_the_trees_serve),
    ("serve-ci-mixed", _refused_request),
])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = tiny.execute(root, cell, seed=11)
    assert not out["correct"], out["checks"]


def test_the_study_control_fails_the_exact_counts(tmp_path):
    import torch

    from port_bench import run
    from port_bench.harness import data, spec
    from port_bench.traffic import sweep

    root = tiny.make_root(tmp_path, sizes={"n_tests": 600, "n_estimators": 8,
                                           "max_depth": 12})
    cell = spec.load_cell("study-scores-hist", root=root)
    state = {"run": run.Run(cell, 21, torch.device("cpu"), str(tmp_path)),
             "study": data.study_data(cell.config, 21)}
    diff = 0
    for model in ("Extra Trees", "Random Forest"):
        keys = ("NOD", "Flake16", "Scaling", "SMOTE", model)
        ref = sweep.reference_counts(state, keys)
        diff += int((sweep.reference_counts(state, keys, lowp=True)
                     != ref).sum())
    assert diff > cell.workload["params"]["check"]["limit"]


def test_the_serving_control_fails_the_limits(tmp_path):
    root = tiny.make_root(tmp_path, sizes={"n_tests": 400, "n_estimators": 8,
                                           "max_depth": 12},
                          check_requests=48)
    import torch

    from port_bench import run
    from port_bench.harness import spec
    from port_bench.harness.tracer import Tracer
    from port_bench.traffic import serve_closed

    cell = spec.load_cell("serve-ci-mixed", root=root)
    state = serve_closed.setup(run.Run(cell, 5, torch.device("cpu"),
                                     str(tmp_path)))
    record = serve_closed.window(state, 1.5, Tracer(False))
    serve_closed.release(state)
    limits = cell.workload["params"]["check"]["limits"]
    sound = serve_closed.check(state, record)
    assert all(c["value"] <= c["limit"] for c in sound.values())
    control = serve_closed.control(state, record)
    assert any(v > limits[k] for k, v in control.items()), control
    assert control["predict_max_abs"] > limits["predict_max_abs"]
    assert np.isfinite(control["shap_max_rel"])
