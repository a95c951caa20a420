"""The slice end to end: the port's ``write_scores`` against the JAX
package's on a synthetic tests.json, and the port's boundaries (the
default device, its imports, the command line).
Grades: per-project counts equal for configs without PCA; total F1 within
+/-0.01 for PCA configs."""

import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from flake16_framework_tpu import pipeline as jpipe
from flake16_framework_tpu.utils.synth import make_tests_json
from flake16_framework_tpu_torch import __main__ as tmain
from flake16_framework_tpu_torch import config as tcfg
from flake16_framework_tpu_torch import device as tdevice
from flake16_framework_tpu_torch import pipeline as tpipe
from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = [
    ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
    ("OD", "Flake16", "None", "Tomek Links", "Extra Trees"),
    ("NOD", "Flake16", "PCA", "SMOTE Tomek", "Extra Trees"),
    ("OD", "Flake16", "PCA", "ENN", "Random Forest"),
]


@pytest.fixture(autouse=True)
def _jax_x64_off():
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    with jax.enable_x64(False):
        yield


def test_write_scores_matches_jax(tmp_path):
    tj = str(tmp_path / "tests.json")
    make_tests_json(tj, n_tests=200, n_projects=5, seed=0)
    kw = dict(max_depth=8, configs=CONFIGS, progress_out=io.StringIO(),
              tree_overrides={"Random Forest": 3, "Extra Trees": 3})
    want = jpipe.write_scores(tj, str(tmp_path / "j.pkl"), journal=False,
                              **kw)
    got = tpipe.write_scores(tj, str(tmp_path / "t.pkl"), device="cpu",
                             **kw)
    assert list(got) == CONFIGS
    for k in CONFIGS:
        g, w = got[k], want[k]
        assert len(g) == 4 and g[0] > 0 and g[1] > 0
        assert list(g[2]) == list(w[2])            # projects, in order
        if k[2] != "PCA":
            assert g[2] == w[2] and g[3] == w[3], k
        else:
            gf, wf = g[3][5], w[3][5]
            assert (gf is None) == (wf is None), k
            if gf is not None:
                assert abs(gf - wf) <= 0.01, (k, gf, wf)
    # a partial scores.pkl is a ledger: completed configs are not rerun
    again = tpipe.write_scores(tj, str(tmp_path / "t.pkl"), device="cpu",
                               **kw)
    assert again == got


def test_default_device_is_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        assert tdevice.resolve().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdevice.resolve()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpipe.write_scores("missing.json")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmain.main(["scores"])
        monkeypatch.chdir(tmp_path)
        open("scores.pkl", "wb").close()   # resume state to resume from
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmain.main(["resume"])
    assert tdevice.resolve("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


_BLOCKED = r'''
import importlib, pkgutil, sys
BLOCK = ("jax", "jaxlib", "flake16_framework_tpu")
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Blocker())
import flake16_framework_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in BLOCK]
print(len(names))
'''


def test_port_imports_nothing_of_jax():
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 59     # every module imported,
    # ``obs/perfdb.py``, ``perf_diff.py``, ``metrics.py`` and
    # ``lockwatch.py`` included


def test_cli_rejects_unknown_input():
    with pytest.raises(ValueError, match="No command"):
        tmain.main([])
    with pytest.raises(ValueError, match="Unrecognized command"):
        tmain.main(["tune"])
    with pytest.raises(ValueError, match="Unrecognized shap option"):
        tmain.main(["shap", "gird"])
    with pytest.raises(ValueError, match="Unrecognized scores option"):
        tmain.main(["scores", "trace=out"])
    with pytest.raises(ValueError, match="profile= needs a directory"):
        tmain.main(["scores", "profile="])
    with pytest.raises(ValueError, match="Unrecognized scores option"):
        tmain.main(["scores", "lopo", "fussed"])


def test_cli_scores_runs_the_whole_grid(monkeypatch):
    calls = []
    monkeypatch.setattr(tpipe, "write_scores", lambda **kw: calls.append(kw))
    tmain.main(["scores"])
    tmain.main(["scores", "lopo"])
    assert calls == [{"cv": "stratified"}, {"cv": "lopo"}]
    # no ``configs``: the engine runs the whole grid, DT configs included
    engine = SweepEngine(np.zeros((4, 16), np.float32), np.zeros(4), {},
                         ["a", "b"], np.array([0, 0, 1, 1]), device="cpu")
    ran = []
    monkeypatch.setattr(engine, "run_config", lambda k: ran.append(k))
    engine.run_grid()
    assert ran == list(tcfg.iter_config_keys()) and len(ran) == 216
    assert sum(k[4] == "Decision Tree" for k in ran) == 72
