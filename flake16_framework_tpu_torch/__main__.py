"""Command line of the port, on the GPU, reading ``tests.json`` in the
working directory and writing there: ``python -m
flake16_framework_tpu_torch scores`` runs the 10-fold CV sweep over all
216 configs into ``scores.pkl``, ``... scores lopo`` the
leave-one-project-out sweep into ``scores-lopo.pkl``, and ``... shap``
writes the Tree SHAP values of the two paper configs into ``shap.pkl``."""

import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise ValueError("No command given")
    command, *args = argv
    if command not in ("scores", "shap"):
        raise ValueError(f"Unrecognized command {command!r} (this slice "
                         f"of the port has: scores, shap)")
    options = ("lopo",) if command == "scores" else ()
    for a in args:
        if a not in options:
            raise ValueError(f"Unrecognized {command} option {a!r}")
    from flake16_framework_tpu_torch.pipeline import write_scores, write_shap

    if command == "shap":
        write_shap()
        return

    write_scores(cv="lopo" if "lopo" in args else "stratified")


if __name__ == "__main__":
    main()
