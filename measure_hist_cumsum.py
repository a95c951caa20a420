"""Measures the histogram kernel K1 (``csrc/hist_cumsum.cu``) on one NVIDIA
GPU on the grower's real BFS steps and on the synthetic full window of
``chip_smoke.py``. The real steps are every step of the first fold's fit of
the two ``scores`` configs at full width (N = 4000 tests, 100 trees, depth
48, W = 128, B = 64), recorded by ``chip_smoke.record_steps``.

Every timed kernel is first held bitwise against the plain version, and
against a second run, on every step. Times are taken on two yardsticks,
both CUDA events over all of a shape's steps: launched back to back
(``chip_smoke._cuda_ms``, host launch overhead included where it sets the
pace) and queued behind a sleeping kernel (``chip_smoke._device_ms``,
device time alone).

Run from the repository root:

``python3 measure_hist_cumsum.py``
    This checkout's K1 in full: the compiler's register, shared-memory and
    spill report, the SASS atomics, resident blocks per SM and waves at the
    main path's shape, the store stream's floor (the kernel given no
    samples, and PyTorch's fill of the same outputs), per-step times by
    occupied rows, the profiler's time of the RF steps, and both
    yardsticks. Also written to ``chiprun_out/hist_cumsum_measure.json``.
``python3 measure_hist_cumsum.py --against DIR [DIR ...]``
    A comparison in turns with other checkouts of the repo (for example a
    parent commit unpacked with ``git archive`` into a directory that
    ``.gitignore`` lists): each DIR, this checkout, this checkout, then
    each DIR in reverse order, each run in a process of its own that
    records the steps with its own package and times its own K1. Also
    written to ``chiprun_out/hist_cumsum_ab.json``.

Each prints the card's name and power limit and one JSON object as its
last line.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from chip_smoke import (MAIN_CONFIGS, N_PROJECTS, N_TESTS, _cuda_ms,
                        _device_ms, hist_bound_ms, launch_steps,
                        record_steps, step_stats, synthetic_hist_inputs)

HERE = os.path.dirname(os.path.abspath(__file__))


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def record_shapes():
    """{shape name: [K1 inputs of each step]}: the synthetic full window,
    and every BFS step of the first fold's fit of each ``scores`` config,
    recorded with the ``flake16_framework_tpu_torch`` package on
    ``sys.path``."""
    from flake16_framework_tpu_torch.data import load_tests, tests_to_arrays
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
    from flake16_framework_tpu_torch.utils.synth import make_tests_json

    with tempfile.TemporaryDirectory() as tmp:
        tj = os.path.join(tmp, "tests.json")
        make_tests_json(tj, n_tests=N_TESTS, n_projects=N_PROJECTS, seed=0)
        engine = SweepEngine(*tests_to_arrays(load_tests(tj)))
    shapes = {"full_window": [synthetic_hist_inputs()]}
    for config in MAIN_CONFIGS:
        shapes[config[4]] = record_steps(engine, config)
    return shapes


def check_and_time(shapes):
    """K1 on every step of each shape, bitwise against the plain version
    and against a second run; then its ms over all of a shape's steps on
    both yardsticks."""
    from flake16_framework_tpu_torch.kernels.hist import (
        cum_hists, cum_hists_plain,
    )

    out = {}
    for name, steps in shapes.items():
        for s in steps:
            got, again, want = cum_hists(*s), cum_hists(*s), \
                cum_hists_plain(*s)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"hist_cumsum differs from plain on "
                                     f"{name}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"hist_cumsum: two runs differ on "
                                     f"{name}")
            del got, again, want
        reps = 20 if len(steps) == 1 else 10
        device_ms, host_ms, queued = _device_ms(lambda: launch_steps(steps),
                                                reps=reps)
        out[name] = {
            "steps": len(steps),
            "back_to_back_ms": _cuda_ms(lambda: launch_steps(steps),
                                        reps=reps),
            "device_ms": device_ms, "queued": queued,
            "host_ms_per_call": host_ms / len(steps),
            "bound_ms": sum(hist_bound_ms(s[0], s[1], s[3], s[4], s[5])[0]
                            for s in steps)}
    return out


def times_only(package):
    """One turn of a comparison: K1 of the package at ``package``."""
    sys.path.insert(0, os.path.abspath(package))
    import flake16_framework_tpu_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(
        flake16_framework_tpu_torch.__file__)))
    if root != os.path.abspath(package):
        raise AssertionError(f"the package came from {root}, not {package}")
    times = check_and_time(record_shapes())
    print(json.dumps({"package": package, "times": times}), flush=True)
    return 0


def against(others, smi):
    """Turns of ``times_only`` processes: others, this checkout twice,
    others reversed."""
    turns = [*others, HERE, HERE, *reversed(others)]
    runs = []
    for package in turns:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--times-only",
             "--package", package], capture_output=True, text=True,
            timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise RuntimeError(f"turn on {package} failed "
                               f"(exit {proc.returncode})")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        label = "this checkout" if package == HERE else package
        for name, t in runs[-1]["times"].items():
            print(f"{label}: {name} {t['steps']} steps, back to back "
                  f"{t['back_to_back_ms']:.4f} ms, device "
                  f"{t['device_ms']:.4f} ms (queued {t['queued']}), bound "
                  f"{t['bound_ms']:.4f} ms", flush=True)
    report = {"nvidia_smi": smi, "turns": [
        {"package": "this checkout" if r["package"] == HERE
         else r["package"], "times": r["times"]} for r in runs]}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "hist_cumsum_ab.json"), "w") as fd:
        json.dump(report, fd, indent=1)
    print(json.dumps(report), flush=True)
    return 0


def full_report(smi):
    """This checkout's K1 in full (see the module docstring)."""
    from flake16_framework_tpu_torch.kernels import build, hist
    from measure_treeshap_unit import sass_census

    log = build.build("hist_cumsum")["hist_cumsum"]
    print(f"nvcc hist_cumsum: {log.strip()}", flush=True)
    census = sass_census(build._lib_path("hist_cumsum"))
    atoms = {k: v for k, v in census["opcodes"].items() if "ATOM" in k}
    print(f"sass hist_cumsum: {census['instructions']} instructions, "
          f"atomics {atoms}", flush=True)

    shapes = record_shapes()
    report = {"nvidia_smi": smi, "nvcc": log, "sass": census, "shapes": {}}
    for name, steps in shapes.items():
        stats = [step_stats(s[0], s[1], s[4]) for s in steps]
        report["shapes"][name] = {
            "steps": len(steps),
            "in_window_share": [st[0] for st in stats],
            "rows_mean": [float(st[1].float().mean()) for st in stats]}

    rel, _, _, bin_t, n_nodes, n_bins = shapes["full_window"][0]
    blocks, n_sm = hist.occupancy(n_nodes, n_bins)
    tiles = rel.shape[0] * -(-bin_t.shape[0] // hist.GROUP)
    report["geometry"] = {
        "group": hist.GROUP, "blocks_per_sm": blocks, "sms": n_sm,
        "tiles": tiles, "smem_bytes": hist.smem_bytes(n_nodes, n_bins),
        "waves": tiles / (blocks * n_sm)}
    print(f"geometry: {json.dumps(report['geometry'])}", flush=True)

    report["times"] = check_and_time(shapes)
    print(f"times: {json.dumps(report['times'])}", flush=True)
    per_step = {}
    for name in (c[4] for c in MAIN_CONFIGS):
        per_step[name] = [
            _device_ms(lambda: hist.cum_hists(*s), reps=10)[0]
            for s in shapes[name]]
        rows = np.array(report["shapes"][name]["rows_mean"])
        for label, sel in (("<= 16 rows", rows <= 16),
                           ("17-64 rows", (rows > 16) & (rows <= 64)),
                           ("> 64 rows", rows > 64)):
            if sel.any():
                print(f"per step {name} {label}: {int(sel.sum())} steps, "
                      f"{np.mean(np.array(per_step[name])[sel]):.4f} ms of "
                      f"device time", flush=True)
    report["per_step_device_ms"] = per_step

    # The store stream alone: the kernel launched with no samples (every
    # row unmarked, written as zeros), and PyTorch's fill of the same
    # outputs as the card's yardstick for writing 104.9 MB.
    fn = hist._launcher()
    out = torch.empty((2, rel.shape[0], bin_t.shape[0], n_nodes, n_bins),
                      device=rel.device)
    stream = torch.cuda.current_stream().cuda_stream
    report["store_floor"] = {
        "zero_fill_ms": _device_ms(out.zero_, reps=20)[0],
        "no_samples_ms": _device_ms(
            lambda: fn(rel.data_ptr(), rel.data_ptr(), rel.data_ptr(),
                       bin_t.data_ptr(), out[0].data_ptr(),
                       out[1].data_ptr(), rel.shape[0], 0, bin_t.shape[0],
                       n_nodes, n_bins, rel.device.index, stream),
            reps=20)[0]}
    del out
    print(f"store floor (device ms): {json.dumps(report['store_floor'])}",
          flush=True)

    # Device time of the kernel under the profiler, over one pass of the
    # RF steps, as a check of the CUDA-event times.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        launch_steps(shapes["Random Forest"])
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "hist_cumsum" in e.key:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            report["profiler_rf"] = {"ms": us / 1e3, "launches": e.count}
            print(f"profiler RF steps: {us / 1e3:.4f} ms over {e.count} "
                  f"launches", flush=True)

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "hist_cumsum_measure.json"),
              "w") as fd:
        json.dump(report, fd, indent=1)
    print(json.dumps({"geometry": report["geometry"],
                      "times": report["times"],
                      "store_floor": report["store_floor"]}), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", nargs="+", metavar="DIR",
                    help="other checkouts to compare with, in turns")
    ap.add_argument("--times-only", action="store_true",
                    help="one turn of a comparison: time the K1 of the "
                         "package at --package")
    ap.add_argument("--package", default=HERE,
                    help="the checkout whose package --times-only loads")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure_hist_cumsum: no CUDA device", file=sys.stderr)
        return 1
    if args.times_only:
        return times_only(args.package)
    smi = nvidia_smi()
    print(smi, flush=True)
    if args.against:
        return against(args.against, smi)
    return full_report(smi)


if __name__ == "__main__":
    sys.exit(main())
