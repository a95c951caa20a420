"""Constants shared with the reference study's artifacts (a copy of the
subset the port needs: file names, label encoding, feature order)."""

TESTS_FILE = "tests.json"
SCORES_FILE = "scores.pkl"
LOPO_SCORES_FILE = "scores-lopo.pkl"
SHAP_FILE = "shap.pkl"
SUBJECTS_FILE = "subjects.txt"

# Label encoding: 1 = order-dependent flaky, 2 = non-order-dependent flaky.
NON_FLAKY, OD_FLAKY, FLAKY = 0, 1, 2

# The 16 Flake16 features, column order fixed: cols 0-2 from coverage,
# 3-8 from rusage, 9-15 static.
FEATURE_NAMES = (
    "Covered Lines", "Covered Changes", "Source Covered Lines",
    "Execution Time", "Read Count", "Write Count", "Context Switches",
    "Max. Threads", "Max. Memory", "AST Depth", "Assertions",
    "External Modules", "Halstead Volume", "Cyclomatic Complexity",
    "Test Lines of Code", "Maintainability"
)

N_FEATURES = len(FEATURE_NAMES)

# FlakeFlagger subset column indices.
FLAKEFLAGGER_COLS = (0, 1, 2, 3, 10, 11, 14)

# Histogram-grower defaults of the JAX package (its F16_* knobs unset);
# the port implements exactly these arms.
HIST_BINS = 64
ET_DRAW = "value"
HIST_REFINE = "exact"
FEATURE_QUOTA = "informative"
