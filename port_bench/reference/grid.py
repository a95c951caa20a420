"""The study's 2x2x3x6x3 grid (the Flake16 study's ``experiment.py``), its
codes and canonical order, and the growers' default arms: the subset of
the port's ``config.py`` and ``constants.py`` that the reference needs."""

import itertools

NON_FLAKY, OD_FLAKY, FLAKY = 0, 1, 2
N_FEATURES = 16
FLAKEFLAGGER_COLS = (0, 1, 2, 3, 10, 11, 14)

FLAKY_TYPES = {"NOD": FLAKY, "OD": OD_FLAKY}
FEATURE_SETS = {"Flake16": tuple(range(N_FEATURES)),
                "FlakeFlagger": FLAKEFLAGGER_COLS}
PREP_NONE, PREP_SCALING, PREP_PCA = 0, 1, 2
PREPROCESSINGS = {"None": PREP_NONE, "Scaling": PREP_SCALING,
                  "PCA": PREP_PCA}
BAL_NONE, BAL_TOMEK, BAL_SMOTE, BAL_ENN, BAL_SMOTE_ENN, BAL_SMOTE_TOMEK = \
    range(6)
BALANCINGS = {"None": BAL_NONE, "Tomek Links": BAL_TOMEK,
              "SMOTE": BAL_SMOTE, "ENN": BAL_ENN,
              "SMOTE ENN": BAL_SMOTE_ENN, "SMOTE Tomek": BAL_SMOTE_TOMEK}
# name: (trees, bootstrap, random splits, sqrt(F) candidate features):
# sklearn 1.0.2's defaults of the three models.
MODELS = {"Extra Trees": (100, False, True, True),
          "Random Forest": (100, True, False, True),
          "Decision Tree": (1, False, False, False)}
GRID_AXES = (FLAKY_TYPES, FEATURE_SETS, PREPROCESSINGS, BALANCINGS, MODELS)

HIST_BINS = 64
ET_DRAW = "value"
HIST_REFINE = "exact"
FEATURE_QUOTA = "informative"


def config_keys():
    """The 216 configs' key tuples in canonical order (the order whose
    index seeds each config's random key)."""
    return [tuple(k) for k in itertools.product(
        *[tuple(d) for d in GRID_AXES])]


def config_index(keys):
    return config_keys().index(tuple(keys))


def resolve(keys):
    """keys -> (flaky label, feature columns, prep code, balancing code,
    (trees, bootstrap, random splits, sqrt features))."""
    flaky, fs, prep, bal, model = keys
    return (FLAKY_TYPES[flaky], FEATURE_SETS[fs], PREPROCESSINGS[prep],
            BALANCINGS[bal], MODELS[model])
