"""One run of each cell on the card, as the check runs it: a subprocess of
``port_bench/run.py`` from the root, its last line the result. Needs the
card; skips without one."""

import json
import os
import subprocess
import sys

import pytest

from port_bench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["study-scores-hist", "serve-ci-mixed",
                                  "serve-ci-predict"])
def test_a_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run on the card")
    out = subprocess.run(
        [sys.executable, os.path.join("port_bench", "run.py"),
         "--workload", cell, "--seed", "3000000019", "--seconds", "10",
         "--trace", "0"], cwd=tiny.ROOT, capture_output=True, text=True,
        timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
