"""Command line of the port, on the GPU, reading ``tests.json`` in the
working directory and writing there: ``python -m
flake16_framework_tpu_torch scores`` runs the CV sweep into ``scores.pkl``
(the Random Forest and Extra Trees configs; the Decision Tree configs need
the exact grower, which is not ported yet), and ``... shap`` writes the
Tree SHAP values of the two paper configs into ``shap.pkl``."""

import sys

from flake16_framework_tpu_torch import config as cfg


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise ValueError("No command given")
    command, *args = argv
    if command not in ("scores", "shap"):
        raise ValueError(f"Unrecognized command {command!r} (this slice "
                         f"of the port has: scores, shap)")
    if args:
        raise ValueError(f"Unrecognized {command} option {args[0]!r}")
    from flake16_framework_tpu_torch.pipeline import write_scores, write_shap

    if command == "shap":
        write_shap()
        return

    write_scores(configs=[k for k in cfg.iter_config_keys()
                          if cfg.MODELS[k[4]].n_trees > 1])


if __name__ == "__main__":
    main()
