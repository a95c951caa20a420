"""The port's sklearn parity oracle (``perf/parity.py``) against the root
``parity.py`` on the CPU, and its cache discipline.

Held: ``ours_config_f1s`` equal to the root ``parity.ours_config_f1s``
on a small tier (N = 240, 3 trees, 2 seeds, the three probe configs;
one seed for the deterministic Decision Tree, as both run it); the
cache refused when a dataset parameter differs or is missing, or when a
config has too few seeds, and a missing cache raising; the ``--full``
verb's lines, verdict and exit code against a cache made for a small
stand-in tier, with the root's ``PARITY.json`` untouched; no run on
``cuda`` without CUDA; the tuner's child command."""

import io
import json
import os
import subprocess

import jax
import numpy as np
import pytest
import torch

import parity as jparity
from flake16_framework_tpu.utils.synth import make_dataset
from flake16_framework_tpu_torch.perf import parity, tuner

SMALL = dict(n_tests=240, n_trees=3)
# The --full verb's stand-in tier.
STAND_IN = dict(n_tests=160, n_trees=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU ops: the suite runs several
    workers on one machine, and PyTorch's default of a thread a core in
    each of them spends most of the CPU waiting. The tests' results do
    not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """No arm set, no database, no dispatch bound on the JAX side;
    64-bit mode off (the root ``parity.py`` turns it on at import)."""
    for name in ("F16_HIST_BINS", "F16_HIST_REFINE", "F16_ET_DRAW",
                 "F16_FEATURE_QUOTA", "F16_PCA_IMPL",
                 "F16_ENSEMBLE_GROWER"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("F16_PERFDB", "0")
    with jax.enable_x64(False):
        yield


def _small_data():
    return make_dataset(n_tests=SMALL["n_tests"], seed=7, **{
        k: v for k, v in parity.DATA.items() if k != "data_seed"})


@pytest.mark.parametrize("keys", parity.PROBE_CONFIGS,
                         ids=lambda k: k[4].replace(" ", ""))
def test_ours_config_f1s_equal_root_parity(keys):
    feats, labels, pids = _small_data()
    seeds = range(1 if keys[4] == "Decision Tree" else 2)
    want = jparity.ours_config_f1s(feats, labels, pids, keys,
                                   n_trees=SMALL["n_trees"], seeds=seeds,
                                   grower="hist")
    got = parity.ours_config_f1s(feats, labels, pids, keys,
                                 n_trees=SMALL["n_trees"], seeds=seeds,
                                 grower="hist", device="cpu")
    assert got == want
    assert parity.PROBE_CONFIGS == jparity.PROBE_CONFIGS


def test_f1_from_conf_equals_root():
    for conf in ((0, 0, 0), (3, 0, 0), (0, 4, 5), (2, 3, 7), (9, 1, 1)):
        assert parity._f1_from_conf(*conf) == jparity._f1_from_conf(*conf)


def _cache(tmp_path, f1s, **over):
    params = dict(SMALL, **parity.DATA)
    params.update(over)
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({**params, "k": 3, "f1s": f1s}))
    return str(path)


def _f1s(value=0.5, k=3):
    return {"/".join(keys): [value + 0.01 * i for i in range(k)]
            for keys in parity.PROBE_CONFIGS}


@pytest.mark.parametrize("over,match", [
    (dict(data_seed=8), "data_seed=8 != this run's 7"),
    (dict(n_trees=100), "n_trees=100 != this run's 3"),
    (dict(noise_sigma=0.4), "noise_sigma=0.4 != this run's 0.35"),
    (dict(nod_bump=None), "nod_bump"),
])
def test_a_cache_from_other_data_is_refused(tmp_path, over, match):
    path = _cache(tmp_path, _f1s(), **over)
    if over.get("nod_bump", 0) is None:
        c = json.loads(open(path).read())
        del c["nod_bump"]
        open(path, "w").write(json.dumps(c))
        match = "cache lacks 'nod_bump'"
    with pytest.raises(ValueError, match=match):
        parity.run_parity(k_ours=2, k_sk=3, sklearn_cache=path, **SMALL,
                          **parity.DATA)


def test_too_few_seeds_and_a_missing_cache_raise(tmp_path):
    path = _cache(tmp_path, _f1s(k=2))
    with pytest.raises(ValueError, match="cache has 2 seeds"):
        parity.run_parity(k_ours=1, k_sk=3, sklearn_cache=path, **SMALL,
                          **parity.DATA)
    with pytest.raises(FileNotFoundError):
        parity.run_parity(k_ours=1, k_sk=3, **SMALL, **parity.DATA,
                          sklearn_cache=str(tmp_path / "absent.json"))
    # the committed cache validates at the full tier's parameters
    c = parity.load_cache(parity.CACHE, dict(
        n_tests=4000, n_trees=100, **parity.DATA))
    assert all(len(v) >= parity.FULL["k_sk"] for v in c["f1s"].values())


def test_full_verb_lines_verdict_and_exit(tmp_path, monkeypatch):
    # --full at a small stand-in tier against a cache far from the port's
    # F1s: the lines, the record, exit 1, and PARITY.json untouched
    monkeypatch.setattr(parity, "FULL", dict(STAND_IN, k_ours=2, k_sk=3))
    monkeypatch.setattr(parity, "CACHE", _cache(tmp_path, _f1s(value=0.95),
                                                **STAND_IN))
    jpath = os.path.join(parity.REPO, "PARITY.json")
    before = os.stat(jpath).st_mtime_ns
    out = io.StringIO()
    assert parity.main(["--full", "--device", "cpu", "--out",
                        str(tmp_path / "rec.json")], out=out) == 1
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert lines[-1] == {"parity_ok": False, "tolerance": 0.01}
    rows = [next(iter(line.values())) for line in lines[:-1]]
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec["ok"] is False and rec["ours_device"] == "cpu"
    assert rec["n_tests"] == STAND_IN["n_tests"]
    for row, keys in zip(rows, parity.PROBE_CONFIGS):
        assert rec["configs"]["/".join(keys)] == row
        dt = keys[4] == "Decision Tree"
        assert row["grower"] == ("exact" if dt else "hist")
        assert row["ours_k"] == len(row["ours_f1s"]) == (1 if dt else 2)
        assert (row["sklearn_k"], row["sklearn_mean"]) == (3, 0.96)
        assert abs(row["delta"] - (np.mean(row["ours_f1s"]) - 0.96)) < 1e-4
        assert row["se_delta"] > 0
    assert os.stat(jpath).st_mtime_ns == before
    # the verdict: every delta within the tolerance, and only then
    report = {k: dict(v, delta=0.01) for k, v in rec["configs"].items()}
    assert parity.full_record(report, "cuda:0")["ok"] is True
    report[next(iter(report))]["delta"] = -0.0101
    assert parity.full_record(report, "cuda:0")["ok"] is False


def test_no_cuda_run_without_cuda_and_full_only(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: nothing to refuse")
    feats, labels, pids = _small_data()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity.ours_config_f1s(feats, labels, pids, parity.PROBE_CONFIGS[0],
                               n_trees=2, seeds=[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity.main(["--full"], out=io.StringIO())
    with pytest.raises(SystemExit) as e:
        parity.main([], out=io.StringIO())
    assert e.value.code == 2


def test_tuner_runs_the_full_tier_in_a_child(monkeypatch):
    calls = []

    def run(cmd, **kw):
        calls.append((cmd, kw))
        return subprocess.CompletedProcess(cmd, 1 if len(calls) > 1 else 0)

    monkeypatch.setattr(tuner.subprocess, "run", run)
    check = tuner.parity_subprocess_check("cuda", timeout_s=60, py="PY")
    assert check({"F16_HIST_BINS": "32"}) is True
    assert check({"F16_HIST_BINS": "48"}) is False
    cmd, kw = calls[0]
    assert cmd == ["PY", "-m", "flake16_framework_tpu_torch.perf.parity",
                   "--full", "--device", "cuda"]
    assert kw["env"]["F16_HIST_BINS"] == "32"
    assert kw["env"]["F16_PERFDB"] == "0" and kw["timeout"] == 60

    def late(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, 60)

    monkeypatch.setattr(tuner.subprocess, "run", late)
    assert check({"F16_HIST_BINS": "32"}) is False
