"""LaTeX table and plot emission of the ``figures`` verb (a copy of the
JAX package's ``figures/tables.py``, numpy only).

The outputs are byte-compatible with the reference study's: the paper's
build consumes these .tex fragments, so cell formats ("%.2f", "-" for zero
ints, the gray rowcolor cadence, cellcolor shading for correlations,
pgfplots coordinate lists) follow its renderers exactly. GitHub star
counts come from an injected ``fetch``; without one the call goes to the
GitHub API, and any failure (no network) gives -1, as the reference's
does.
"""

import numpy as np

from flake16_framework_tpu_torch.utils.atomic import atomic_write


def cell_default(cell):
    if isinstance(cell, str):
        return cell
    if isinstance(cell, float):
        return "%.2f" % cell
    if isinstance(cell, (int, np.integer)):
        return "-" if cell == 0 else str(cell)
    return ""


def cell_corr(cell):
    if isinstance(cell, str):
        return cell
    if isinstance(cell, float):
        if np.isnan(cell):
            # degenerate (zero-variance) feature columns have no defined
            # rank correlation; the study data never produces these, so
            # the byte-compat contract is unaffected
            return "--"
        return "\\cellcolor{gray!%d} %.2f" % (int(50 * abs(cell)), cell)
    return ""


def cell_shap(cell):
    if isinstance(cell, str):
        return cell
    if isinstance(cell, float):
        return "%.3f" % cell
    return ""


def render_table(path, sections, *, rowcol=True, cellfn=cell_default):
    """sections: list of row-lists; a \\midrule separates sections; even rows
    (1-based within the table) get a gray rowcolor when ``rowcol``."""
    with atomic_write(path, "w") as fd:
        for s, rows in enumerate(sections):
            if s:
                fd.write("\\midrule\n")
            for r, row in enumerate(rows):
                if rowcol and r % 2:
                    fd.write("\\rowcolor{gray!20}\n")
                fd.write(" & ".join(cellfn(c) for c in row) + " \\\\\n")


def github_stars(repo, fetch=None):
    """Stargazer count; -1 when unavailable (offline or API error)."""
    try:
        if fetch is None:
            import requests

            info = requests.get(
                f"https://api.github.com/repos/{repo}", timeout=10
            ).json()
        else:
            info = fetch(repo)
        return info.get("stargazers_count", -1)
    except Exception:
        return -1


def req_runs_coords(req_runs):
    """CDF coordinates at run counts 100..2500, normalized by the 2500 mark
    (reference get_req_runs_plot_coords experiment.py:538-545)."""
    marks = [100 * (i + 1) for i in range(25)]
    counts = [
        sum(freq for runs, freq in req_runs.items() if runs <= m)
        for m in marks
    ]
    total = counts[-1]
    if not total:
        # a dataset with no tests of this flaky type renders an empty
        # plot rather than dividing by zero (the reference's study data
        # always has both types; arbitrary datasets may not)
        return ""
    return " ".join(f"({m},{c / total})" for m, c in zip(marks, counts))


def render_req_runs_plot(path, req_runs_nod, req_runs_od):
    with atomic_write(path, "w") as fd:
        fd.write(
            f"\\addplot[mark=x,only marks] coordinates "
            f"{{{req_runs_coords(req_runs_nod)}}};\n"
        )
        fd.write("\\addlegendentry{NOD}\n")
        fd.write(
            f"\\addplot[mark=o,only marks] coordinates "
            f"{{{req_runs_coords(req_runs_od)}}};\n"
        )
        fd.write("\\addlegendentry{OD}")


def spearman_matrix(features):
    """Spearman rank correlation of the feature matrix: average ranks
    (midrank ties) then Pearson corrcoef, with numpy alone."""
    x = np.asarray(features, dtype=np.float64)
    n, f = x.shape
    ranks = np.empty_like(x)
    for j in range(f):
        order = np.argsort(x[:, j], kind="mergesort")
        r = np.empty(n)
        r[order] = np.arange(1, n + 1)
        # midranks for ties
        vals = x[order, j]
        i = 0
        while i < n:
            k = i
            while k + 1 < n and vals[k + 1] == vals[i]:
                k += 1
            if k > i:
                r[order[i : k + 1]] = (i + 1 + k + 1) / 2.0
            i = k + 1
        ranks[:, j] = r
    return np.corrcoef(ranks, rowvar=False)


def top_config_tables(scores):
    """Top-10-by-F1 tables (reference get_top_tables experiment.py:559-574):
    4 buckets by (flaky type, feature set); NOD/OD tables pair FlakeFlagger
    and Flake16 rows side by side."""
    buckets = [[] for _ in range(4)]
    for config_keys, v in scores.items():
        # v[:4]: tolerate wider-than-reference entries (defensive only —
        # our writers emit the exact 4-element schema).
        t_train, t_test, _, total = v[:4]
        flaky_type, feature_set, *rest = config_keys
        f = total[-1]
        i = 2 * (flaky_type == "OD") + (feature_set == "Flake16")
        buckets[i].append((*rest, t_train, t_test, f))

    for i in range(4):
        buckets[i] = sorted(
            (c for c in buckets[i] if c[-1] is not None), key=lambda c: -c[-1]
        )

    # The reference assumes >= 10 scored configs per bucket (true on the real
    # dataset, IndexError otherwise); clamp so degenerate datasets still
    # render a shorter table.
    n_nod = min(10, len(buckets[0]), len(buckets[1]))
    n_od = min(10, len(buckets[2]), len(buckets[3]))
    tab_nod = [[buckets[0][i] + buckets[1][i] for i in range(n_nod)]]
    tab_od = [[buckets[2][i] + buckets[3][i] for i in range(n_od)]]
    return tab_nod, tab_od


def comparison_table(scores_a, scores_b):
    """Per-project side-by-side of two configs, rows where both have complete
    P/R/F (reference get_comparison_table experiment.py:577-586)."""
    # [2:4], not [2:]: tolerate wider-than-reference entries (defensive
    # only — our writers emit the exact 4-element schema).
    per_a, total_a = scores_a[2:4]
    per_b, total_b = scores_b[2:4]
    rows = [
        [proj, *row_a, *per_b[proj]]
        for proj, row_a in per_a.items()
        if all(v is not None for v in row_a)
        and all(v is not None for v in per_b[proj])
    ]
    return [rows, [["{\\bf Total}", *total_a, *total_b]]]


def shap_table(shap_nod, shap_od, feature_names):
    """Mean-|SHAP| feature ranking, NOD and OD side by side
    (reference get_shap_table experiment.py:589-598)."""
    def ranked(sv):
        pairs = zip(feature_names, np.abs(np.asarray(sv)).mean(axis=0))
        return sorted(pairs, key=lambda p: -p[1])

    nod, od = ranked(shap_nod), ranked(shap_od)
    return [[(*nod[i], *od[i]) for i in range(len(feature_names))]]
