"""The config batch across processes (``parallel/distributed.py``,
``SweepEngine(group=)``, ``device.rank_devices`` and the dry-run tool
``tools/multihost_dryrun.py``), on the CPU over ``gloo`` on loopback: 2
ranks x 2 "cpu" devices against one process on 4 and against the JAX
package's mesh path on the same data (counts bitwise equal); where a
padded batch's pad lands; staged against fused; a failing rank, which
must end every rank with an error; and the single-process verbs refused
under a group."""

import json
import os
import pickle
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from flake16_framework_tpu.parallel import sweep as jsweep
from flake16_framework_tpu_torch import device as tdevice
from flake16_framework_tpu_torch.parallel import distributed
from flake16_framework_tpu_torch.parallel.sweep import (
    SweepEngine, batch_layout,
)
from flake16_framework_tpu_torch.tools import multihost_dryrun as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, PROJECTS, TREES, DEPTH = 240, 6, 4, 8
BASE = ["--device", "cpu", "--n", str(N), "--projects", str(PROJECTS),
        "--trees", str(TREES), "--depth", str(DEPTH)]


def _dryrun(out, *extra, timeout_s=150):
    """(exit code, the JSON line, {name: results pickle}) of the tool."""
    p = subprocess.Popen(
        [sys.executable, "-m", tool.TOOL, *BASE, "--out", str(out), *extra],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        stdout, stderr = p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()
        raise
    lines = stdout.strip().splitlines()
    assert lines, stderr[-2000:]
    got = {}
    for name in os.listdir(out):
        if name.endswith(".pkl"):
            with open(os.path.join(out, name), "rb") as fd:
                got[name[:-4]] = pickle.load(fd)
    return p.returncode, json.loads(lines[-1]), got


def _values(results):
    return pickle.dumps([r[2:] for r in results])


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """2 ranks x 2 "cpu" devices, then one process on 4: a batch of 4."""
    return _dryrun(tmp_path_factory.mktemp("staged"),
                   "--devices-per-proc", "2", "--batch", "4")


@pytest.fixture(scope="module")
def fused_pad(tmp_path_factory):
    """A batch of 3 over 2 ranks x 1 device, fused: one pad."""
    return _dryrun(tmp_path_factory.mktemp("pad"), "--devices-per-proc",
                   "1", "--batch", "3", "--fused")


def test_two_ranks_equal_one_process_and_the_jax_mesh(staged):
    rc, line, got = staged
    assert rc == 0 and line["multihost_dryrun_ok"] is True, line
    assert (line["procs"], line["devices_per_proc"], line["batch"]) == \
        (2, 2, 4)
    assert line["shared_card"] is False
    assert line["rank_devices"] == [["cpu", "cpu"]] * 2
    assert line["single_devices"] == ["cpu"] * 4
    assert all(w > 0 for w in line["rank_wall_s"] + line["rank_gather_s"])
    single = got["single"]["results"]
    assert len(single) == 4
    for r in (0, 1):
        assert _values(got[f"rank{r}"]["results"]) == _values(single)
    # the JAX package's mesh path on the same data, one batch of 4
    configs = tool.batch_configs(4)
    with jax.enable_x64(False):
        eng = jsweep.SweepEngine(*tool.dataset(N, PROJECTS),
                                 max_depth=DEPTH,
                                 tree_overrides={tool.MODEL: TREES},
                                 mesh=jsweep.default_mesh())
        want = eng.run_grid(configs, batch_size=4)
    assert set(eng.amortized_configs) == set(configs)
    for keys, res in zip(configs, single):
        assert pickle.dumps(res[2:]) == pickle.dumps(want[keys][2:]), keys


def test_pad_lands_where_one_process_puts_it(fused_pad):
    rc, line, got = fused_pad
    assert rc == 0 and line["multihost_dryrun_ok"] is True, line
    configs = tool.batch_configs(3)
    padded, layout = batch_layout(configs, 2)
    assert padded == configs + [configs[0]]
    # rank r's one card holds the r-th shard of one process's two cards
    assert line["single_devices"] == ["cpu", "cpu"]
    assert [got[f"rank{r}"]["stats"]["shards"] for r in (0, 1)] == \
        [[layout[0]], [layout[1]]] == [[configs[:2]],
                                       [[configs[2], configs[0]]]]
    for r in (0, 1):
        results = got[f"rank{r}"]["results"]
        assert len(results) == 3
        assert _values(results) == _values(got["single"]["results"])


def test_staged_and_fused_agree(staged, fused_pad):
    assert _values(fused_pad[2]["single"]["results"]) == \
        _values(staged[2]["single"]["results"][:3])
    assert all(r[1] == 0.0 for r in fused_pad[2]["rank0"]["results"])


@pytest.mark.parametrize("mode", ["raise", "exit"])
def test_a_failing_rank_ends_every_rank(tmp_path, mode):
    rc, line, _ = _dryrun(tmp_path, "--batch", "2", "--fail-rank", "1",
                          "--fail-mode", mode, "--timeout", "60")
    assert rc == 1 and line["multihost_dryrun_ok"] is False
    rcs = line["rank_rcs"]
    # both ranks exited of themselves (None: killed at the deadline)
    assert None not in rcs and 0 not in rcs, line
    assert line["ranks_s"] < 60
    survivor = line["rank_errors"]["0"]
    if mode == "raise":
        assert "RankFailed" in survivor and "rank 1 failed" in survivor \
            and "drill: rank 1's fit fails" in survivor, survivor
        assert "rank 1 failed" in line["rank_errors"]["1"]
    else:
        assert rcs[1] == 17
        assert "GatherFailed" in survivor, survivor


@pytest.fixture
def one_rank_group(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    group = distributed.join(f"file://{tmp_path / 'rendezvous'}", 1, 0,
                             timeout_s=60)
    try:
        yield group
    finally:
        group.close()
        torch.set_num_threads(n)


def test_a_group_of_one_and_what_it_refuses(one_rank_group, tmp_path):
    group = one_rank_group
    arrays = tool.dataset(N, PROJECTS)
    kw = dict(max_depth=DEPTH, tree_overrides={tool.MODEL: TREES},
              devices=["cpu"] * 2)
    configs = tool.batch_configs(2)
    plain = SweepEngine(*arrays, **kw).run_config_batch(configs)
    grouped = SweepEngine(*arrays, group=group, **kw)
    assert _values(grouped.run_config_batch(configs)) == _values(plain)
    assert group.gather_s is not None
    with pytest.raises(ValueError, match="run_grid runs in one process"):
        grouped.run_grid(configs)
    grouped.journal = object()
    with pytest.raises(ValueError, match="journal-free"):
        grouped.run_config_batch(configs)
    # a failing thunk: the rank still gathers, then raises naming itself
    with pytest.raises(distributed.RankFailed, match="rank 0 failed: "
                       "ZeroDivisionError"):
        group.gather(lambda: 1 / 0)
    assert group.gather(lambda: np.arange(2))[0].tolist() == [0, 1]
    with pytest.raises(RuntimeError, match="joined a group already"):
        distributed.join(f"file://{tmp_path / 'again'}", 1, 0)
    with pytest.raises(ValueError, match="not in a world"):
        distributed.join(f"file://{tmp_path / 'bad'}", 2, 2)


def test_rank_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert tdevice.rank_devices(1, 2, 2, "cpu") == ([cpu, cpu], False)
    with pytest.raises(ValueError):
        tdevice.rank_devices(2, 2, 1, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert tdevice.rank_devices(0, 2, 2) == (cuda[:2], False)
    assert tdevice.rank_devices(1, 2, 2) == (cuda[2:], False)
    # fewer cards than the ranks ask for: each rank drives cuda:0
    assert tdevice.rank_devices(1, 3, 2) == (cuda[:1], True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tdevice.rank_devices(0, 2, 1) == (cuda[:1], True)
    assert tdevice.rank_devices(1, 2, 1) == (cuda[:1], True)
    assert tdevice.rank_devices(0, 1, 1) == (cuda[:1], False)
