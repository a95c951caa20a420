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
router (``--fleet W``; ``serve/cli.py``). With ``F16_TELEMETRY`` set,
every command writes its events and manifest (``obs/``). ``scores`` and ``resume``
also take ``planner`` (the configs run as family plans), ``fused`` (each
config's folds grown as one tree batch) and ``dispatch=N`` (at most N
trees a fold grown as one batch), and exit with 23 when configs were
quarantined (``scores.pkl.quarantine.json`` lists them)."""

import os
import sys

# Options of the JAX package's ``scores`` that the port does not have yet,
# and what brings them (ROADMAP.md, queue A).
_LATER = {
    "profile=": "the port's telemetry (ROADMAP.md §A 6)",
}


def _scores_kwargs(command, args):
    kw = {"cv": "stratified"}
    for a in args:
        if a == "lopo":
            kw["cv"] = "lopo"
        elif a in ("planner", "fused"):
            kw[a] = True
        elif a.startswith("dispatch="):
            kw["dispatch_trees"] = int(a.split("=", 1)[1]) or None
        else:
            head, eq, _ = a.partition("=")
            later = _LATER.get(head + eq)
            raise ValueError(f"Unrecognized {command} option {a!r}" + (
                f": not in the port yet; it comes with {later}" if later
                else ""))
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


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise ValueError("No command given")
    command, *args = argv
    from flake16_framework_tpu_torch import obs

    obs.configure_from_env()
    if command not in ("scores", "resume", "shap", "figures", "serve"):
        raise ValueError(f"Unrecognized command {command!r} (this slice "
                         f"of the port has: scores, resume, shap, figures, "
                         f"serve)")
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
