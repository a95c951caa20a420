"""The ``figures`` verb (a copy of the JAX package's
``figures/report.py``): every paper artifact from ``tests.json``,
``scores.pkl`` and ``shap.pkl``: tests.tex, req-runs.tex, corr.tex,
nod-top.tex, od-top.tex, nod-comp.tex, od-comp.tex and shap.tex, with the
reference's file names and its comparison configs."""

import json
import os
import pickle

from flake16_framework_tpu_torch.constants import (
    FEATURE_NAMES, FLAKY, OD_FLAKY, SCORES_FILE, SHAP_FILE, TESTS_FILE,
)
from flake16_framework_tpu_torch.figures import tables as T
from flake16_framework_tpu_torch.runner.subjects import iter_subjects

NOD_COMPARISON = (
    ("NOD", "FlakeFlagger", "None", "Tomek Links", "Extra Trees"),
    ("NOD", "Flake16", "PCA", "SMOTE", "Extra Trees"),
)
OD_COMPARISON = (
    ("OD", "FlakeFlagger", "None", "SMOTE Tomek", "Extra Trees"),
    ("OD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
)


def write_figures(tests_file=TESTS_FILE, scores_file=SCORES_FILE,
                  shap_file=SHAP_FILE, subjects=None, star_fetch=None,
                  out_dir="."):
    os.makedirs(out_dir, exist_ok=True)

    def out(name):
        return f"{out_dir}/{name}"

    with open(tests_file, "r") as fd:
        tests = json.load(fd)

    if subjects is None:
        subjects = list(iter_subjects())

    # --- tests.tex + req-runs.tex -------------------------------------------
    rows = []
    totals = ["{\\bf Total}", 0, 0, 0, 0]
    req_runs_nod, req_runs_od = {}, {}
    features = []

    for subject in subjects:
        tests_proj = tests[subject.name]
        row = [subject.repo, T.github_stars(subject.repo, star_fetch),
               len(tests_proj), 0, 0]

        for (req_runs, label, *feats) in tests_proj.values():
            if label == FLAKY:
                row[3] += 1
                req_runs_nod[req_runs] = req_runs_nod.get(req_runs, 0) + 1
            elif label == OD_FLAKY:
                row[4] += 1
                req_runs_od[req_runs] = req_runs_od.get(req_runs, 0) + 1
            features.append(feats)

        for j in range(1, 5):
            totals[j] += row[j]
        rows.append(row)

    T.render_table(out("tests.tex"), [rows, [totals]])
    T.render_req_runs_plot(out("req-runs.tex"), req_runs_nod, req_runs_od)

    # --- corr.tex -----------------------------------------------------------
    corr = T.spearman_matrix(features)
    tab_corr = [[[name, *corr[i]] for i, name in enumerate(FEATURE_NAMES)]]
    T.render_table(out("corr.tex"), tab_corr, rowcol=False, cellfn=T.cell_corr)

    # --- top/comparison tables ----------------------------------------------
    with open(scores_file, "rb") as fd:
        scores = pickle.load(fd)

    tab_nod, tab_od = T.top_config_tables(scores)
    T.render_table(out("nod-top.tex"), tab_nod)
    T.render_table(out("od-top.tex"), tab_od)

    T.render_table(
        out("nod-comp.tex"),
        T.comparison_table(scores[NOD_COMPARISON[0]], scores[NOD_COMPARISON[1]]),
    )
    T.render_table(
        out("od-comp.tex"),
        T.comparison_table(scores[OD_COMPARISON[0]], scores[OD_COMPARISON[1]]),
    )

    # --- shap.tex -----------------------------------------------------------
    with open(shap_file, "rb") as fd:
        shap_nod, shap_od = pickle.load(fd)

    T.render_table(
        out("shap.tex"), T.shap_table(shap_nod, shap_od, FEATURE_NAMES),
        cellfn=T.cell_shap,
    )
