"""The config batch across processes, against one process (the port's
counterpart of the JAX package's ``tools/multihost_dryrun.py``).

    python -m flake16_framework_tpu_torch.tools.multihost_dryrun \\
        [--device cpu] [--devices-per-proc K] [--n 300] [--projects 6] \\
        [--trees 16] [--depth 12] [--batch 8] [--fused]

The parent picks a free loopback address and spawns two ranks (the JAX
tool's two processes), each in a process group of its own and killed at
``--timeout``. Each rank joins the ``gloo`` group
(``parallel/distributed.py``), takes its K cards (``device.
rank_devices``: a disjoint slice when there are enough, else ``cuda:0``
shared by both ranks) and runs one batch of ``--batch`` Flake16 Extra
Trees configs without PCA through ``SweepEngine(group=...)
.run_config_batch``: the batch split over both ranks' cards, the counts
all-gathered. Then the parent runs the same batch in its own process on
2K devices (one card when fewer are visible). Every rank's results must equal the one process's bit for
bit; the parent prints one JSON line (``multihost_dryrun_ok``, the sizes,
``shared_card``, each rank's wall, gather wall, K1 launches and peak
allocated memory, the one process's) and exits 1 when they differ or a
rank failed. It runs on ``cuda`` unless given ``--device cpu``; on the
CPU every process computes on one thread, so they sum alike.

The data is ``utils.synth.make_dataset`` at seed 9, the JAX tool's; the
sweep's 10 stratified folds. ``--fail-rank R`` is a drill: rank R's fit
raises (``--fail-mode raise``) or its process exits at once (``exit``),
and every rank must then exit with an error, not hang.
"""

import argparse
import json
import os
import pickle
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from flake16_framework_tpu_torch.utils.atomic import atomic_write

PKG_ROOT = Path(__file__).resolve().parents[2]
TOOL = "flake16_framework_tpu_torch.tools.multihost_dryrun"
MODEL = "Extra Trees"
SEED = 9
PROCS = 2
PREPS = ("None", "Scaling")


def batch_configs(batch):
    """The first ``batch`` configs of the Flake16 Extra Trees family
    without PCA, flaky type, preprocessing and balancing varied in turn
    (the JAX tool's pattern)."""
    from flake16_framework_tpu_torch import config as cfg

    fls, bals = list(cfg.FLAKY_TYPES), list(cfg.BALANCINGS)
    most = len(fls) * len(PREPS) * len(bals)
    if not 1 <= batch <= most:
        raise ValueError(f"--batch must be in 1..{most}")
    return [(fls[i % 2], "Flake16", PREPS[i // 2 % 2], bals[i % 6], MODEL)
            for i in range(batch)]


def dataset(n, n_projects):
    """The engine's arrays (features, labels, projects, project names,
    project ids) of the synthetic dataset at seed 9."""
    from flake16_framework_tpu_torch.utils.synth import make_dataset

    feats, labels, pids = make_dataset(n_tests=n, n_projects=n_projects,
                                       seed=SEED)
    names = [f"project{p:02d}" for p in range(n_projects)]
    return (feats.astype(np.float32), labels,
            np.array([names[p] for p in pids]), names, pids)


def _engine(args, devices, group=None):
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    return SweepEngine(*dataset(args.n, args.projects), max_depth=args.depth,
                       tree_overrides={MODEL: args.trees}, devices=devices,
                       fused=args.fused, group=group)


def _run_batch(args, engine):
    """(results, stats) of the batch on ``engine``: the wall, K1's
    launches and the peak allocated bytes on the engine's cards."""
    import torch

    from flake16_framework_tpu_torch.kernels.hist import cum_hists

    cuda = [d for d in engine.devices if d.type == "cuda"]
    if cuda:
        torch.cuda.synchronize()
    for d in cuda:
        torch.cuda.reset_peak_memory_stats(d)
    k1 = cum_hists.launches
    t0 = time.time()
    # The batch ends with its counts copied to the host from every card.
    results = engine.run_config_batch(batch_configs(args.batch))
    return results, {
        "wall_s": time.time() - t0, "k1_launches": cum_hists.launches - k1,
        "peak_allocated_bytes": max(
            (torch.cuda.max_memory_allocated(d) for d in cuda),
            default=None)}


def _fail(engine, rank, mode):
    """The drill: this rank's fit raises, or its process exits."""
    def fit(*a, **kw):
        if mode == "exit":
            os._exit(17)
        raise RuntimeError(f"drill: rank {rank}'s fit fails")
    engine._fit_groups = fit


def rank_main(args):
    """One rank: join the group, run the batch over every rank's cards,
    write its results and stats (with the shards its cards ran,
    ``sweep.batch_layout``) to ``<out>/rank<r>.pkl``."""
    import torch

    from flake16_framework_tpu_torch.device import rank_devices
    from flake16_framework_tpu_torch.parallel import distributed
    from flake16_framework_tpu_torch.parallel.sweep import batch_layout

    if args.device == "cpu":
        torch.set_num_threads(1)
    with distributed.join(args.init_method, PROCS, args.rank,
                          args.timeout) as group:
        devices, shared = rank_devices(args.rank, PROCS,
                                       args.devices_per_proc, args.device)
        engine = _engine(args, devices, group)
        if args.fail_rank == args.rank:
            _fail(engine, args.rank, args.fail_mode)
        results, stats = _run_batch(args, engine)
        k = len(devices)
        stats.update(rank=args.rank, gather_s=group.gather_s,
                     shared_card=shared, devices=[str(d) for d in devices],
                     shards=batch_layout(batch_configs(args.batch),
                                         PROCS * k)[1][
                         args.rank * k:(args.rank + 1) * k])
    with atomic_write(Path(args.out) / f"rank{args.rank}.pkl") as fd:
        pickle.dump({"results": results, "stats": stats}, fd)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(args, out):
    """Start the ranks, each in a process group of its own; returns
    [Popen]."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(PKG_ROOT), os.environ.get("PYTHONPATH")) if p))
    argv = [sys.executable, "-m", TOOL, "--device", args.device,
            "--devices-per-proc", str(args.devices_per_proc),
            "--n", str(args.n), "--projects", str(args.projects),
            "--trees", str(args.trees), "--depth", str(args.depth),
            "--batch", str(args.batch), "--timeout", str(args.timeout),
            "--out", str(out), "--init-method", init,
            "--fail-rank", str(args.fail_rank), "--fail-mode",
            args.fail_mode] + (["--fused"] if args.fused else [])
    procs = []
    try:
        for r in range(PROCS):
            # the child's output stream, read back only as a log
            with open(out / f"rank{r}.log", "w") as log:  # f16lint: disable=J701 (a log stream)
                procs.append(subprocess.Popen(
                    argv + ["--rank", str(r)], stdout=log,
                    stderr=subprocess.STDOUT, env=env,
                    start_new_session=True))
    except OSError:
        _wait_ranks(procs, 0.0)
        raise
    return procs


def _wait_ranks(procs, timeout_s):
    """Each rank's exit code; a rank still running at the deadline is
    killed with its process group (exit code None)."""
    deadline = time.time() + timeout_s
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(0.0, deadline - time.time())))
        except subprocess.TimeoutExpired:
            rcs.append(None)
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    return rcs


def _last_error(log_path):
    lines = [ln for ln in log_path.read_text().splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def run(args):
    """The parent: the ranks, then one process; returns the JSON line."""
    own_out = args.out is None
    out = Path(tempfile.mkdtemp(prefix="f16-multihost-") if own_out
               else args.out)
    out.mkdir(parents=True, exist_ok=True)
    line = {"multihost_dryrun_ok": False, "procs": PROCS,
            "devices_per_proc": args.devices_per_proc, "batch": args.batch,
            "n": args.n, "trees": args.trees, "depth": args.depth,
            "device": args.device, "fused": args.fused}
    try:
        t0 = time.time()
        rcs = _wait_ranks(_spawn_ranks(args, out), args.timeout)
        line["ranks_s"] = time.time() - t0
        line["rank_rcs"] = rcs
        if rcs != [0] * PROCS:
            line["rank_errors"] = {r: _last_error(out / f"rank{r}.log")
                                   for r in range(PROCS)}
            return line
        ranks = []
        for r in range(PROCS):
            with open(out / f"rank{r}.pkl", "rb") as fd:
                ranks.append(pickle.load(fd))
        import torch  # after the ranks: the parent waits on them first

        from flake16_framework_tpu_torch.device import rank_devices

        if args.device == "cpu":
            torch.set_num_threads(1)
        devices, single_shared = rank_devices(
            0, 1, PROCS * args.devices_per_proc, args.device)
        single, stats = _run_batch(args, _engine(args, devices))
        with atomic_write(out / "single.pkl") as fd:
            pickle.dump({"results": single, "stats": stats}, fd)
        want = pickle.dumps([r[2:] for r in single])
        same = [pickle.dumps([res[2:] for res in rk["results"]]) == want
                for rk in ranks]
        line.update(
            multihost_dryrun_ok=all(same) and len(single) == args.batch,
            shared_card=any(rk["stats"]["shared_card"] for rk in ranks),
            single_shared_card=single_shared,
            rank_wall_s=[rk["stats"]["wall_s"] for rk in ranks],
            rank_gather_s=[rk["stats"]["gather_s"] for rk in ranks],
            rank_k1_launches=[rk["stats"]["k1_launches"] for rk in ranks],
            rank_peak_allocated_bytes=[
                rk["stats"]["peak_allocated_bytes"] for rk in ranks],
            rank_devices=[rk["stats"]["devices"] for rk in ranks],
            single_devices=[str(d) for d in devices],
            single_wall_s=stats["wall_s"],
            single_k1_launches=stats["k1_launches"],
            single_peak_allocated_bytes=stats["peak_allocated_bytes"],
            counts=[[row[:3] for row in r[2].values()] for r in single])
        return line
    finally:
        if own_out:
            shutil.rmtree(out, ignore_errors=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog=f"python -m {TOOL}",
        description="A config batch across processes against one process.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--devices-per-proc", type=int, default=1)
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--projects", type=int, default=6)
    ap.add_argument("--trees", type=int, default=16)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for the ranks, and the group's timeout")
    ap.add_argument("--out", default=None,
                    help="directory for the results (rank<r>.pkl, "
                         "single.pkl) and the ranks' logs (default: a "
                         "temporary one, removed)")
    ap.add_argument("--fail-rank", type=int, default=-1)
    ap.add_argument("--fail-mode", default="raise", choices=("raise", "exit"))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.devices_per_proc < 1:
        ap.error("--devices-per-proc must be at least 1")
    batch_configs(args.batch)
    return args


def main(argv=None):
    """Run the dry run (or, with ``--rank``, one rank of it); prints the
    JSON line and returns it, exiting 1 when it is not ok."""
    args = parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return None
    line = run(args)
    print(json.dumps(line), flush=True)
    if not line["multihost_dryrun_ok"]:
        raise SystemExit(1)
    return line


if __name__ == "__main__":
    main()
