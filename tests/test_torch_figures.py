"""The port's ``figures`` verb against the JAX package's: from the same
``tests.json``, ``scores.pkl`` and ``shap.pkl`` both write the same eight
.tex files, byte for byte. Star counts come from a stub fetch, or from the
default path with the ``requests`` module blocked, so no test reaches the
network."""

import os
import pickle
import sys

import numpy as np
import pytest

from flake16_framework_tpu import config as jcfg
from flake16_framework_tpu.figures import report as jreport
from flake16_framework_tpu.runner import subjects as jsubjects
from flake16_framework_tpu_torch import __main__ as tmain
from flake16_framework_tpu_torch.figures import report as treport
from flake16_framework_tpu_torch.runner import subjects as tsubjects
from flake16_framework_tpu_torch.utils.synth import make_tests_json

TEX = ("tests.tex", "req-runs.tex", "corr.tex", "nod-top.tex", "od-top.tex",
       "nod-comp.tex", "od-comp.tex", "shap.tex")


@pytest.fixture(autouse=True)
def _no_requests(monkeypatch):
    """``import requests`` fails: the default star fetch returns -1."""
    monkeypatch.setitem(sys.modules, "requests", None)


def _row(rs):
    """One reference-schema score row: FP, FN, TP, then P, R, F1 (None
    where undefined)."""
    fp, fn, tp = (int(v) for v in rs.randint(0, 9, 3))
    prec = tp / (tp + fp) if tp + fp else None
    rec = tp / (tp + fn) if tp + fn else None
    f1 = 2 * prec * rec / (prec + rec) if prec and rec else None
    return [fp, fn, tp, prec, rec, f1]


def _inputs(d, n_tests=300, n_projects=5, seed=4):
    """tests.json (synthetic), a scores.pkl over the whole grid and a
    shap.pkl of two [N, 16] arrays, in directory ``d``."""
    tests = make_tests_json(os.path.join(d, "tests.json"), n_tests=n_tests,
                            n_projects=n_projects, seed=seed)
    rs = np.random.RandomState(seed)
    scores = {}
    for k in jcfg.iter_config_keys():
        per = {p: _row(rs) for p in tests}
        total = [sum(r[i] for r in per.values()) for i in range(3)]
        scores[k] = [float(rs.rand()), float(rs.rand()), per,
                     total + _row(rs)[3:]]
    with open(os.path.join(d, "scores.pkl"), "wb") as fd:
        pickle.dump(scores, fd)
    shap = [rs.randn(n_tests, 16).astype(np.float32) for _ in range(2)]
    with open(os.path.join(d, "shap.pkl"), "wb") as fd:
        pickle.dump(shap, fd)
    return tests


def _read(d):
    out = {}
    for name in TEX:
        with open(os.path.join(d, name), "rb") as fd:
            out[name] = fd.read()
    return out


@pytest.mark.parametrize("fetch", [
    lambda repo: {"stargazers_count": 7 * len(repo)},
    lambda repo: {},
], ids=["stars", "no-stars"])
def test_write_figures_matches_jax(tmp_path, fetch):
    tests = _inputs(str(tmp_path))
    files = {k: str(tmp_path / f) for k, f in (
        ("tests_file", "tests.json"), ("scores_file", "scores.pkl"),
        ("shap_file", "shap.pkl"))}
    for pkg, rep, sub in (("j", jreport, jsubjects), ("t", treport,
                                                      tsubjects)):
        subjects = [sub.Subject(name=p, repo=f"org/{p}", sha="x",
                                package_dir=".", commands=("pytest",))
                    for p in tests]
        rep.write_figures(**files, subjects=subjects, star_fetch=fetch,
                          out_dir=str(tmp_path / pkg))
    want, got = _read(tmp_path / "j"), _read(tmp_path / "t")
    assert got == want
    assert got["tests.tex"].count(b"org/") == len(tests)
    assert b"\\addlegendentry{NOD}" in got["req-runs.tex"]


def test_figures_verb_matches_jax(tmp_path, monkeypatch):
    """``python -m flake16_framework_tpu_torch figures`` in a directory
    with the three inputs and a ``subjects.txt`` of its projects."""
    tests = _inputs(str(tmp_path), n_tests=200, n_projects=4, seed=9)
    with open(tmp_path / "subjects.txt", "w") as fd:
        fd.write("# the synthetic projects\n")
        for p in tests:
            fd.write(f"org/{p},abc123,.,pytest\n")
    monkeypatch.chdir(tmp_path)
    tmain.main(["figures"])
    got = _read(tmp_path)
    jreport.write_figures(star_fetch=lambda repo: {}, out_dir="j")
    assert got == _read(tmp_path / "j")
    assert b" & -1 & " in got["tests.tex"]
    with pytest.raises(ValueError, match="Unrecognized figures option"):
        tmain.main(["figures", "now"])


def _subject_lines(path):
    with open(path) as fd:
        return [line for line in fd if not line.lstrip().startswith("#")]


def test_subject_registry_matches_jax(tmp_path, monkeypatch):
    """The packaged subject lines equal the JAX package's (their comment
    headers differ), and parse to the same subjects."""
    assert _subject_lines(tsubjects.PACKAGED_SUBJECTS_FILE) \
        == _subject_lines(jsubjects.PACKAGED_SUBJECTS_FILE)
    monkeypatch.chdir(tmp_path)        # no subjects.txt here
    got = [tuple(vars(s).values()) for s in tsubjects.iter_subjects()]
    want = [tuple(vars(s).values()) for s in jsubjects.iter_subjects()]
    assert got == want and len(got) == 26
    assert next(tsubjects.iter_subjects()).url.startswith(
        "https://github.com/")
