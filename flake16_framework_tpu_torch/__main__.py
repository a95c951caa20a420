"""Command line of the port, on the GPU, reading ``tests.json`` in the
working directory and writing there: ``python -m
flake16_framework_tpu_torch scores`` runs the 10-fold CV sweep over all
216 configs into ``scores.pkl``, ``... scores lopo`` the
leave-one-project-out sweep into ``scores-lopo.pkl``, ``... resume
[lopo]`` continues a killed sweep from its journal or partial pickle,
``... shap`` writes the Tree SHAP values of the two paper configs into
``shap.pkl``, ``... shap grid|interventional|interaction [explain=N]
[background=N]`` the path-dependent, interventional (against a background
of N samples) or interaction values of N samples for every config of the
grid into ``shap-<mode>.pkl``, and ``... figures`` the paper's LaTeX
tables and plots from ``tests.json``, ``scores.pkl`` and ``shap.pkl``
(host code, no device), and ``... serve [--flags]`` stands the scoring
service up in one process, or as a fleet of worker processes behind a
router (``--fleet W``; ``serve/cli.py``). ``scores`` and ``resume``
also take ``planner`` (the configs run as family plans), ``fused`` (each
config's folds grown as one tree batch), ``dispatch=N`` (at most N trees a
fold grown as one batch) and ``profile=DIR`` (a ``torch.profiler`` capture
of the sweep, written as a Chrome trace in DIR), and exit with 23 when
configs were quarantined (``scores.pkl.quarantine.json`` lists them).

With ``F16_TELEMETRY`` set (``1``, or a root directory), every command
writes its events and manifest into a run directory (``obs/``):
``scores``, ``resume`` and ``shap`` their spans, counters, journal and
fault events, ``serve`` its own. ``... report [RUN_DIR] [--json]
[--attrib] [--flight]`` summarizes a run (the newest under the root by
default; ``--attrib`` ranks configs by wall with their stages and kernel
launches), and ``... trace [RUN_DIR] [--out FILE]`` (or ``trace --fleet
[ROOT]``) converts it into Chrome-trace JSON.

``... perf backfill|ingest|diff|sentinel|lookup`` is the performance
database (``obs/perfdb.py``, ``obs/perf_diff.py``; the path is
``--db PATH``, else ``F16_PERFDB``, else ``_scratch/perfdb.jsonl``):
``backfill`` ingests the committed ``BENCH_r*.json`` trajectory,
``ingest PATH... [--round TAG]`` adds bench results, telemetry run dirs
(this package's rows carry its kernels' launches) or audit documents,
``diff A B [--json] [--top N] [--perfetto FILE]`` joins two rounds or
runs per kernel/stage and ranks the deltas, ``sentinel [--json]
[--strict] [--threshold PCT]`` flags step-changes over the committed
trajectory, and ``lookup BACKEND SHAPE [KERNEL] [--json]`` prints the
best-known knob row that the planner (``plan_pad_to``), the plan
executor (the hist grower's window width) and ``serve`` (its warm
buckets) consult. Like ``report`` and ``trace``, it starts no telemetry
run."""

import os
import sys


def _scores_kwargs(command, args):
    kw = {"cv": "stratified"}
    for a in args:
        if a == "lopo":
            kw["cv"] = "lopo"
        elif a in ("planner", "fused"):
            kw[a] = True
        elif a.startswith("dispatch="):
            kw["dispatch_trees"] = int(a.split("=", 1)[1]) or None
        elif a.startswith("profile="):
            kw["profile_dir"] = a.split("=", 1)[1]
            if not kw["profile_dir"]:
                raise ValueError(f"{command}: profile= needs a directory")
        else:
            raise ValueError(f"Unrecognized {command} option {a!r}")
    return kw


def _shap(args):
    """Bare ``shap``: the two paper configs into ``shap.pkl``. With a mode
    (``grid`` is the path-dependent one), every config of the grid into
    ``shap-<mode>.pkl``, ``explain=N``/``background=N`` sizing the
    explained and background rows (defaults 64 and 32)."""
    from flake16_framework_tpu_torch import pipeline

    mode = None
    kw = {}
    for a in args:
        if a in ("grid", "interventional", "interaction"):
            if mode is not None:
                raise ValueError("shap: give at most one mode")
            mode = a
        elif a.startswith("explain="):
            kw["n_explain"] = int(a.split("=", 1)[1])
        elif a.startswith("background="):
            kw["n_background"] = int(a.split("=", 1)[1])
        else:
            raise ValueError(f"Unrecognized shap option {a!r}")
    if mode is None:
        if kw:
            raise ValueError("shap: explain=/background= need a mode "
                             "(grid|interventional|interaction)")
        pipeline.write_shap()
    else:
        pipeline.shap_grid(out_file=f"shap-{mode}.pkl",
                           mode="path" if mode == "grid" else mode, **kw)


_COMMANDS = ("scores", "resume", "shap", "figures", "serve", "report",
             "trace", "perf")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise ValueError("No command given")
    command, *args = argv
    from flake16_framework_tpu_torch import obs

    if command not in _COMMANDS:
        raise ValueError(f"Unrecognized command {command!r} (this slice "
                         f"of the port has: {', '.join(_COMMANDS)})")
    if command == "report":
        from flake16_framework_tpu_torch.obs.report import report_main

        report_main(args)
        return
    if command == "trace":
        from flake16_framework_tpu_torch.obs.trace import trace_main

        trace_main(args)
        return
    if command == "perf":
        from flake16_framework_tpu_torch.obs.perf_diff import perf_main

        perf_main(args)
        return
    obs.configure_from_env()
    if command == "serve":
        from flake16_framework_tpu_torch.serve.cli import serve_main

        code = serve_main(args)
        if code:
            raise SystemExit(code)
        return
    if command == "figures":
        for a in args:
            raise ValueError(f"Unrecognized figures option {a!r}")
        from flake16_framework_tpu_torch.figures.report import write_figures

        write_figures()
        return
    from flake16_framework_tpu_torch import pipeline

    if command == "shap":
        _shap(args)
        return
    kw = _scores_kwargs(command, args)
    if command == "resume":
        # The same sweep as ``scores``, but it requires resume state, so
        # a mistyped invocation never silently starts from scratch.
        from flake16_framework_tpu_torch.constants import (
            LOPO_SCORES_FILE, SCORES_FILE,
        )
        from flake16_framework_tpu_torch.resilience.journal import (
            journal_path,
        )

        out_file = LOPO_SCORES_FILE if kw["cv"] == "lopo" else SCORES_FILE
        jpath = journal_path(out_file)
        if not (os.path.exists(jpath) or os.path.exists(out_file)):
            raise ValueError(
                f"resume: no resume state — neither {jpath} nor "
                f"{out_file} exists (run `scores` for a fresh sweep)")
    # QuarantinedConfigs is a SystemExit: the process exits with 23.
    pipeline.write_scores(**kw)


if __name__ == "__main__":
    main()
