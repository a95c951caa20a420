"""Command line of the port: ``python -m flake16_framework_tpu_torch
scores`` runs the CV sweep on ``tests.json`` in the working directory and
writes ``scores.pkl`` there, on the GPU. This slice of the port runs the
Random Forest and Extra Trees configs; the Decision Tree configs need the
exact grower, which is not ported yet."""

import sys

from flake16_framework_tpu_torch import config as cfg


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise ValueError("No command given")
    command, *args = argv
    if command != "scores":
        raise ValueError(f"Unrecognized command {command!r} (this slice "
                         f"of the port has: scores)")
    if args:
        raise ValueError(f"Unrecognized scores option {args[0]!r}")
    from flake16_framework_tpu_torch.pipeline import write_scores

    write_scores(configs=[k for k in cfg.iter_config_keys()
                          if cfg.MODELS[k[4]].n_trees > 1])


if __name__ == "__main__":
    main()
