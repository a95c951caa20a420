"""The whole ``scores`` grid of the PyTorch/CUDA port on one card, as a user
runs it: ``python -m flake16_framework_tpu_torch scores`` in a directory
that holds only a synthetic ``tests.json`` (``utils/synth.py``, seed 0,
N = 4000 tests over 26 projects), all 216 configs, 10 folds, depth 48.

Prints the card's name and power limit, the command's wall, the sums
of the configs' own walls (10 x (t_train + t_test), the per-fold means of
``scores.pkl``) by model, and the write-ahead journal's appends and their
wall (its closing line in the log), and checks the pickle's schema. Run
from the repository root: ``python3 measure_grid.py``; details go to
``chiprun_out/measure_grid.json`` and the command's output to
``chiprun_out/measure_grid.log``. Needs one CUDA device; exits non-zero
without one.

``--config KEYS --against DIR`` instead times one config's
``SweepEngine.run_config`` on the same data in this checkout and in each
other checkout DIR (a ``git archive`` of another commit), each in its own
process, in turns (A B B A for two trees), ``--reps`` timed runs a process
after one untimed. Output: ``chiprun_out/measure_config.json``.

``--planner`` runs the grid ``--pairs`` times (default 2) in each of two
modes in the same call, each run in a directory of its own: ``scores
planner`` (the plan executor) and the default ``scores``, in turns (P D D
P for two pairs), the kernels built once before any. Every run's wall and
its sums by model, and each pair's planner / default ratios, go to
``chiprun_out/measure_grid.json`` (``runs``, ``pairs``).

``--launches --against DIR`` counts the device launches, by kernel name,
of one profiled ``run_config`` of each ``--config`` (default: the RF, ET
and DT configs below) in this checkout and in DIR, each in a process of
its own, and reports the names whose counts differ. Output:
``chiprun_out/launches.json``.

``--shap grid|interventional|interaction`` (may be given more than once)
instead times the whole grid's SHAP values of that mode through the CLI
(``python -m flake16_framework_tpu_torch shap <mode>``, ``explain=64``,
``background=32``), in a directory of its own after the kernels are
built, and checks ``shap-<mode>.pkl`` (216 configs, f32, shapes, finite
values, symmetric interaction matrices). The command's wall and the
members' fit and explain walls summed by model go to
``chiprun_out/measure_shap_grid.json``, each run's output to
``chiprun_out/measure_shap_<mode>.log``.

``--check-profiler`` profiles one run of each of ``--config`` (or of the
RF, ET and DT configs that ``chip_smoke.py`` profiles) and holds
``chip_smoke.py``'s reading of the profiler's raw device events against
``key_averages()``: launches and device ms per kernel name. Output:
``chiprun_out/check_profiler.json``.
"""

import argparse
import hashlib
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_TESTS, N_PROJECTS, N_FOLDS = 4000, 26, 10
REPO = os.path.dirname(os.path.abspath(__file__))
CHECK_CONFIGS = ("NOD/Flake16/Scaling/SMOTE/Random Forest",
                 "OD/Flake16/PCA/SMOTE Tomek/Extra Trees",
                 "NOD/Flake16/Scaling/SMOTE/Decision Tree")

# One checkout's timed runs of one config; run with that checkout as the
# working directory, so that it imports that checkout's package.
_TIME_CONFIG = """
import json, sys, time, torch
from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
tests_file, config, reps = sys.argv[1], sys.argv[2], int(sys.argv[3])
config = tuple(config.split("/"))
engine = SweepEngine(*tests_to_arrays(load_tests(tests_file)))
engine.run_config(config)
walls = []
for _ in range(reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_config(config)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
print(json.dumps(walls))
"""


# One checkout's device launches by kernel name over one profiled run of a
# config (after one unprofiled run); run with that checkout as the working
# directory.
_COUNT_LAUNCHES = """
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from chip_smoke import _device_kernels
from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
tests_file, config = sys.argv[1], tuple(sys.argv[2].split("/"))
engine = SweepEngine(*tests_to_arrays(load_tests(tests_file)))
engine.run_config(config)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    engine.run_config(config)
    torch.cuda.synchronize()
print(json.dumps({name: n for _, name, n in _device_kernels(prof)}))
"""


def launches_against(configs, other):
    """Launches by kernel name of each config here and in ``other``."""
    trees = {"this": REPO, "other": os.path.abspath(other)}
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        tests_file = _make_tests(tmp)
        for config in configs:
            counts = {}
            for name, tree in trees.items():
                run = subprocess.run(
                    [sys.executable, "-c", _COUNT_LAUNCHES, tests_file,
                     config], cwd=tree, env=dict(os.environ, PYTHONPATH=tree),
                    capture_output=True, text=True, timeout=900)
                if run.returncode != 0:
                    raise RuntimeError(f"{tree}: exit {run.returncode}\n"
                                       f"{run.stderr[-4000:]}")
                counts[name] = json.loads(run.stdout.strip().splitlines()[-1])
            a, b = counts["this"], counts["other"]
            out.append({"config": config, "this": sum(a.values()),
                        "other": sum(b.values()),
                        "differ": {k[:160]: [a.get(k, 0), b.get(k, 0)]
                                   for k in sorted(set(a) | set(b))
                                   if a.get(k, 0) != b.get(k, 0)}})
    return {"other": other, "configs": out}


def _make_tests(tmp):
    from flake16_framework_tpu_torch.utils.synth import make_tests_json

    path = os.path.join(tmp, "tests.json")
    make_tests_json(path, n_tests=N_TESTS, n_projects=N_PROJECTS, seed=0)
    return path


def _write_report(name, report):
    with open(os.path.join(REPO, "chiprun_out", name), "w") as fd:
        json.dump(report, fd, indent=1)
    print(json.dumps(report), flush=True)


def time_config_in_turns(config, others, rounds, reps):
    """Walls of ``config`` in this checkout and in each of ``others``, in
    turns: round r runs the trees in order, or reversed when r is odd.
    A round's mean wall per tree makes one pair with this checkout's."""
    trees = [REPO] + [os.path.abspath(d) for d in others]
    walls = {t: [] for t in trees}
    with tempfile.TemporaryDirectory() as tmp:
        tests_file = _make_tests(tmp)
        for r in range(rounds):
            for tree in (trees if r % 2 == 0 else trees[::-1]):
                run = subprocess.run(
                    [sys.executable, "-c", _TIME_CONFIG, tests_file, config,
                     str(reps)], cwd=tree, env=dict(os.environ,
                                                    PYTHONPATH=tree),
                    capture_output=True, text=True, timeout=900)
                if run.returncode != 0:
                    raise RuntimeError(f"{tree}: exit {run.returncode}\n"
                                       f"{run.stderr[-4000:]}")
                walls[tree].append(
                    json.loads(run.stdout.strip().splitlines()[-1]))
    stats = {}
    for tree, per_round in walls.items():
        w = sorted(x for rw in per_round for x in rw)
        q = [w[int(f * (len(w) - 1))] for f in (0.25, 0.5, 0.75)]
        stats[os.path.relpath(tree, REPO)] = {
            "walls_s": per_round, "min_s": w[0], "q1_s": q[0],
            "median_s": q[1], "q3_s": q[2], "mean_s": math.fsum(w) / len(w),
            "round_means_s": [math.fsum(rw) / len(rw) for rw in per_round]}
    mine = stats["."]
    for tree in trees[1:]:
        st = stats[os.path.relpath(tree, REPO)]
        st["rounds_this_tree_slower"] = sum(
            a > b for a, b in zip(mine["round_means_s"],
                                  st["round_means_s"]))
        st["this_tree_median_minus_s"] = mine["median_s"] - st["median_s"]
    return {"config": config, "rounds": rounds, "reps": reps,
            "trees": stats}


def _raw_vs_averaged(prof):
    """{name: [raw ms, raw launches, averaged ms, averaged launches]} of the
    device events of a finished profile, read both ways."""
    from torch.autograd import DeviceType

    from chip_smoke import _device_kernels

    both = {name: [ms, n, 0.0, 0]
            for ms, name, n in _device_kernels(prof)}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        row = both.setdefault(e.key, [0.0, 0, 0.0, 0])
        row[2] += e.self_device_time_total / 1e3
        row[3] += e.count
    return both


def check_profiler(configs):
    """Profile one run of each config and compare the two readings."""
    from torch.profiler import ProfilerActivity, profile

    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    out = []
    with tempfile.TemporaryDirectory() as tmp:
        engine = SweepEngine(*tests_to_arrays(load_tests(_make_tests(tmp))))
        for config in configs:
            keys = tuple(config.split("/"))
            engine.run_config(keys)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                engine.run_config(keys)
                torch.cuda.synchronize()
            both = _raw_vs_averaged(prof)
            launch_diff = [n for n, r in both.items() if r[1] != r[3]]
            ms_diff = max((abs(r[0] - r[2]) for r in both.values()),
                          default=0.0)
            out.append({
                "config": config, "kernel_names": len(both),
                "raw_launches": sum(r[1] for r in both.values()),
                "averaged_launches": sum(r[3] for r in both.values()),
                "raw_busy_ms": math.fsum(r[0] for r in both.values()),
                "averaged_busy_ms": math.fsum(r[2] for r in both.values()),
                "names_with_other_launches": launch_diff[:10],
                "max_abs_ms_diff_per_name": ms_diff,
                "agree": not launch_diff and ms_diff <= 1e-3})
    return {"torch": torch.__version__, "configs": out,
            "agree": all(c["agree"] for c in out)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", action="append", default=[],
                    help="config keys joined by '/'")
    ap.add_argument("--against", action="append", default=[],
                    help="another checkout to time --config in turns with")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--check-profiler", action="store_true")
    ap.add_argument("--launches", action="store_true",
                    help="with --against: device launches by kernel name")
    ap.add_argument("--planner", action="store_true",
                    help="time `scores planner` and `scores` in turns")
    ap.add_argument("--pairs", type=int, default=2,
                    help="with --planner: runs of each mode")
    ap.add_argument("--shap", action="append", default=[],
                    choices=("grid", "interventional", "interaction"),
                    help="time the whole grid's SHAP values of this mode")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure_grid: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    if args.launches:
        if len(args.against) != 1:
            ap.error("--launches compares with exactly one --against")
        report = launches_against(args.config or CHECK_CONFIGS,
                                  args.against[0])
        _write_report("launches.json", dict(report, nvidia_smi=smi))
        return 0
    if args.against:
        if len(args.config) != 1:
            ap.error("--against times exactly one --config")
        report = time_config_in_turns(args.config[0], args.against,
                                      args.rounds, args.reps)
        _write_report("measure_config.json", dict(report, nvidia_smi=smi))
    if args.check_profiler:
        report = check_profiler(args.config or CHECK_CONFIGS)
        _write_report("check_profiler.json", dict(report, nvidia_smi=smi))
        if not report["agree"]:
            print("measure_grid: the profiler readings differ",
                  file=sys.stderr)
            return 1
    if args.check_profiler or args.against:
        return 0
    if args.shap:
        from flake16_framework_tpu_torch.kernels import build

        build.build("hist_cumsum", "treeshap_unit")    # outside the walls
        runs = [shap_grid_run(word) for word in args.shap]
        _write_report("measure_shap_grid.json", {"nvidia_smi": smi,
                                                 "runs": runs})
        return 0 if all(runs) else 1
    if not args.planner:
        report = grid_run(["scores"], "measure_grid.log")
        if report is None:
            return 1
        _write_report("measure_grid.json", dict(report, nvidia_smi=smi))
        return 0
    from flake16_framework_tpu_torch.kernels import build

    build.build("hist_cumsum")             # outside both walls
    argvs = {"planner": ["scores", "planner"], "default": ["scores"]}
    runs = []
    for i in range(args.pairs):
        order = ("planner", "default") if i % 2 == 0 \
            else ("default", "planner")
        for mode in order:
            run = grid_run(argvs[mode], f"measure_grid_{mode}_{i}.log")
            if run is None:
                return 1
            runs.append(dict(run, mode=mode, pair=i))
    same = len({r["scores_sha256"] for r in runs}) == 1
    pairs = []
    for i in range(args.pairs):
        p, d = (next(r for r in runs if r["pair"] == i and r["mode"] == m)
                for m in ("planner", "default"))
        pairs.append({
            "order": [r["mode"] for r in runs if r["pair"] == i],
            "planner_over_default_wall": p["wall_s"] / d["wall_s"],
            "planner_over_default_by_model": {
                m: p["by_model"][m]["sum_s"] / d["by_model"][m]["sum_s"]
                for m in d["by_model"]}})
    _write_report("measure_grid.json", {
        "nvidia_smi": smi, "runs": runs, "pairs": pairs,
        "scores_equal": same})
    if not same:
        print("measure_grid: the runs' scores differ (planner and default "
              "must agree)", file=sys.stderr)
        return 1
    return 0


_MEMBER_LINE = re.compile(r"^\[\d+/\d+\] (.+) \(fit ([0-9.]+) s, explain "
                          r"([0-9.]+) s;", re.M)


def shap_grid_run(word):
    """``shap <word>`` over the whole grid through the CLI, in a directory
    of its own; returns its report, or None if it failed."""
    from flake16_framework_tpu_torch import config as cfg

    log_path = os.path.join(REPO, "chiprun_out", f"measure_shap_{word}.log")
    with tempfile.TemporaryDirectory() as tmp:
        _make_tests(tmp)
        env = dict(os.environ, PYTHONPATH=REPO)
        with open(log_path, "w") as log:
            t0 = time.time()
            rc = subprocess.run(
                [sys.executable, "-m", "flake16_framework_tpu_torch",
                 "shap", word], cwd=tmp, env=env, stdout=log,
                stderr=subprocess.STDOUT, timeout=3000).returncode
            wall = time.time() - t0
        if rc != 0:
            print(f"measure_grid: shap {word} exited {rc}; see {log_path}",
                  file=sys.stderr)
            return None
        with open(os.path.join(tmp, f"shap-{word}.pkl"), "rb") as fd:
            payload = pickle.load(fd)
    values = payload["values"]
    grid = ["/".join(k) for k in cfg.iter_config_keys()]
    if sorted(values) != sorted(grid):
        raise AssertionError(f"shap-{word}.pkl holds {len(values)} "
                             f"configs, not the grid's {len(grid)}")
    for name, v in values.items():
        f = len(cfg.FEATURE_SETS[name.split("/")[1]])
        shape = (64, f, f) if word == "interaction" else (64, f)
        if v.dtype != np.float32 or v.shape != shape \
                or not np.isfinite(v).all():
            raise AssertionError(f"{name}: {v.dtype} {v.shape}")
        if word == "interaction" and not np.array_equal(
                v, v.transpose(0, 2, 1)):
            raise AssertionError(f"{name}: not symmetric")
    with open(log_path) as fd:
        members = _MEMBER_LINE.findall(fd.read())
    if len(members) != len(grid):
        raise AssertionError(f"{len(members)} member lines in {log_path}")
    by_model = {}
    for keys, fit_s, explain_s in members:
        m = by_model.setdefault(keys.split(", ")[4], {
            "configs": 0, "fit_s": 0.0, "explain_s": 0.0,
            "max_explain_s": 0.0})
        m["configs"] += 1
        m["fit_s"] += float(fit_s)
        m["explain_s"] += float(explain_s)
        m["max_explain_s"] = max(m["max_explain_s"], float(explain_s))
    return {"command": f"shap {word}", "mode": payload["mode"],
            "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "configs": len(values), "wall_s": wall,
            "member_sum_s": sum(m["fit_s"] + m["explain_s"]
                                for m in by_model.values()),
            "by_model": by_model}


def grid_run(argv, log_name):
    """The whole grid through the CLI (``argv`` after the module name), in
    a directory of its own; returns its report, or None if it failed."""
    from flake16_framework_tpu_torch import config as cfg

    log_path = os.path.join(REPO, "chiprun_out", log_name)
    with tempfile.TemporaryDirectory() as tmp:
        _make_tests(tmp)
        env = dict(os.environ, PYTHONPATH=REPO)
        with open(log_path, "w") as log:
            t0 = time.time()
            rc = subprocess.run(
                [sys.executable, "-m", "flake16_framework_tpu_torch",
                 *argv], cwd=tmp, env=env, stdout=log,
                stderr=subprocess.STDOUT, timeout=3000).returncode
            wall = time.time() - t0
        if rc != 0:
            print(f"measure_grid: {' '.join(argv)} exited {rc}; see "
                  f"{log_path}", file=sys.stderr)
            return None
        with open(os.path.join(tmp, "scores.pkl"), "rb") as fd:
            scores = pickle.load(fd)
        with open(os.path.join(tmp, "scores.pkl.meta.json")) as fd:
            meta = json.load(fd)
    with open(log_path) as fd:
        m = re.search(r"^journal: (\d+) appends in ([0-9.]+) s of "
                      r"([0-9.]+) s$", fd.read(), re.M)
    if m is None:
        raise AssertionError(f"no journal line in {log_path}")
    journal = {"n_appends": int(m[1]), "append_wall_s": float(m[2]),
               "sweep_wall_s": float(m[3]),
               "append_share": float(m[2]) / float(m[3])}

    grid = list(cfg.iter_config_keys())
    if sorted(scores) != sorted(grid):
        raise AssertionError(f"scores.pkl holds {len(scores)} configs, "
                             f"not the grid's {len(grid)}")
    by_model = {}
    for k in grid:
        t_train, t_test, per_proj, total = scores[k]
        if len(per_proj) != N_PROJECTS or not t_train > 0:
            raise AssertionError(f"{k}: {len(per_proj)} projects, "
                                 f"t_train {t_train}")
        if total[5] is not None and not 0.0 <= total[5] <= 1.0:
            raise AssertionError(f"{k}: F1 {total[5]}")
        m = by_model.setdefault(k[4], {"configs": 0, "sum_s": 0.0,
                                       "f1": []})
        m["configs"] += 1
        m["sum_s"] += N_FOLDS * (t_train + t_test)
        if total[5] is not None:
            m["f1"].append(total[5])
    for m in by_model.values():
        f1 = m.pop("f1")
        m["mean_s"] = m["sum_s"] / m["configs"]
        m["f1_mean"] = math.fsum(f1) / len(f1) if f1 else None
    return {"command": " ".join(argv),
            "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "configs": len(scores), "wall_s": wall,
            "config_sum_s": sum(m["sum_s"] for m in by_model.values()),
            "by_model": by_model, "journal": journal,
            "meta_fused_combined": len(meta["fused_combined"]),
            "meta_batch_amortized": len(meta["batch_amortized"]),
            "scores_sha256": hashlib.sha256(pickle.dumps(
                [scores[k][2:] for k in grid])).hexdigest()}


if __name__ == "__main__":
    sys.exit(main())
