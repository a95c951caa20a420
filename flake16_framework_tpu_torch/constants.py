"""Constants shared with the reference study's artifacts (a copy of the
subset the port needs: file names, image paths, run counts, label
encoding, feature order). The values are cross-process contracts and
equal the JAX package's."""

import os

LOG_FILE = "log.txt"
TESTS_FILE = "tests.json"
SCORES_FILE = "scores.pkl"
LOPO_SCORES_FILE = "scores-lopo.pkl"
SHAP_FILE = "shap.pkl"
SUBJECTS_FILE = "subjects.txt"
REQUIREMENTS_FILE = "requirements.txt"

DATA_DIR = "data"
STDOUT_DIR = "stdout"
WORK_DIR = os.path.join("/", "home", "user")
SUBJECTS_DIR = os.path.join(WORK_DIR, "subjects")
CONT_DATA_DIR = os.path.join(WORK_DIR, DATA_DIR)

CONT_TIMEOUT = 7200
# Pinned for reproducibility, at a version that supports the Python 3.12
# venvs of the containers.
PIP_VERSION = "pip==24.0"
IMAGE_NAME = "flake16framework"
PIP_INSTALL = ["pip", "install", "-I", "--no-deps"]

# Label encoding: 1 = order-dependent flaky, 2 = non-order-dependent flaky.
NON_FLAKY, OD_FLAKY, FLAKY = 0, 1, 2

# Runs per mode.
N_RUNS = {"baseline": 2500, "shuffle": 2500, "testinspect": 1}

# pytest plugins that interfere with flakiness measurement.
PLUGIN_BLACKLIST = (
    "-p", "no:cov", "-p", "no:flaky", "-p", "no:xdist", "-p", "no:sugar",
    "-p", "no:replay", "-p", "no:forked", "-p", "no:ordering",
    "-p", "no:randomly", "-p", "no:flakefinder", "-p", "no:random_order",
    "-p", "no:rerunfailures",
)

# Setup installs the framework source tree (both packages; the image
# copies it here) into every subject venv with --no-deps.
FRAMEWORK_DIR = os.path.join(WORK_DIR, "framework")
PLUGINS = (FRAMEWORK_DIR,)

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

# The growers' arms with their F16_* variables unset, the JAX package's
# defaults (ops/trees.py resolves each at the call).
HIST_BINS = 64
ET_DRAW = "value"
HIST_REFINE = "exact"
FEATURE_QUOTA = "informative"

# Predict's walk with F16_PREDICT_IMPL and F16_PREDICT_WINDOW unset, the
# JAX package's defaults (ops/trees.py reads both at each call).
PREDICT_IMPL = "gather"
PREDICT_WINDOW = 128
