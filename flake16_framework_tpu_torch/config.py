"""The 2x2x3x6x3 experiment grid as data: integer codes for the runtime
axes and a static ``ModelSpec`` per model. Key order and names match the
reference grid, so ``scores.pkl`` keys are interchangeable, and the config
index (which seeds each config's RNG key) is the same."""

import itertools
from dataclasses import dataclass

from flake16_framework_tpu_torch.constants import (
    FLAKY, OD_FLAKY, N_FEATURES, FLAKEFLAGGER_COLS
)

FLAKY_TYPES = {"NOD": FLAKY, "OD": OD_FLAKY}

FEATURE_SETS = {
    "Flake16": tuple(range(N_FEATURES)),
    "FlakeFlagger": FLAKEFLAGGER_COLS,
}

PREP_NONE, PREP_SCALING, PREP_PCA = 0, 1, 2
PREPROCESSINGS = {"None": PREP_NONE, "Scaling": PREP_SCALING, "PCA": PREP_PCA}

BAL_NONE, BAL_TOMEK, BAL_SMOTE, BAL_ENN, BAL_SMOTE_ENN, BAL_SMOTE_TOMEK = range(6)
BALANCINGS = {
    "None": BAL_NONE,
    "Tomek Links": BAL_TOMEK,
    "SMOTE": BAL_SMOTE,
    "ENN": BAL_ENN,
    "SMOTE ENN": BAL_SMOTE_ENN,
    "SMOTE Tomek": BAL_SMOTE_TOMEK,
}


@dataclass(frozen=True)
class ModelSpec:
    """Static description of a tree-ensemble model: sklearn 1.0.2 defaults
    of the three reference models (100-tree ensembles, gini, unbounded
    depth; RF/ET use max_features=sqrt(F), DT all features)."""

    name: str
    n_trees: int
    bootstrap: bool
    random_splits: bool  # True: ExtraTrees uniform-random thresholds
    sqrt_features: bool  # True: sqrt(F) candidate features per split


MODELS = {
    "Extra Trees": ModelSpec("Extra Trees", 100, False, True, True),
    "Random Forest": ModelSpec("Random Forest", 100, True, False, True),
    "Decision Tree": ModelSpec("Decision Tree", 1, False, False, False),
}

GRID_AXES = (FLAKY_TYPES, FEATURE_SETS, PREPROCESSINGS, BALANCINGS, MODELS)


def iter_config_keys():
    """All 216 config key-tuples in the reference sweep order."""
    return itertools.product(*[tuple(d.keys()) for d in GRID_AXES])


def resolve_config(config_keys):
    """Key tuple -> (flaky_label, feature_cols, prep_code, bal_code, ModelSpec)."""
    flaky_type, feature_set, prep, bal, model = config_keys
    return (
        FLAKY_TYPES[flaky_type],
        FEATURE_SETS[feature_set],
        PREPROCESSINGS[prep],
        BALANCINGS[bal],
        MODELS[model],
    )


# The two configs explained with Tree SHAP, in ``shap.pkl`` order.
SHAP_CONFIGS = (
    ("NOD", "Flake16", "Scaling", "SMOTE Tomek", "Extra Trees"),
    ("OD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
)
