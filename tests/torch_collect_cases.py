"""Inputs of the collection stage, shared by the collation and plugin
tests (tests/test_torch_collate.py, tests/test_torch_plugins.py) and by
``chip_smoke.py``'s ``collect_chain`` and ``collate_scale`` phases, which
import this file by path. Imports neither jax nor either package: numpy
and the standard library only.

``write_data_dir`` writes a ``data/`` directory in the collection plugins'
own formats, made from a synthetic dataset, and returns the
``tests.json`` its collation must give, built here without the
collation code. ``make_chain_subject`` and ``collect`` make a toy git
subject and run real plugins on it in pytest subprocesses.

For each project ``project{pid:02d}`` of the dataset and each of its
tests ``tests/test_<proj>.py::test_{j:04d}``:

- showflakes TSVs, ``<proj>_baseline_<k>.tsv`` and ``<proj>_shuffle_<k>.tsv``
  for every run k of ``n_runs``: one ``outcome\\tnodeid`` line a test, in
  definition order for baseline runs and in a fresh seeded order for
  shuffle runs. A test's outcome in a mode is a step in the run number,
  ``before`` for runs under its threshold and ``after`` from it on, chosen
  to give its label and its required runs r (drawn in [1, n - 1] for a
  flaky test, where n is the deciding mode's run count):

  - NON_FLAKY: passes everywhere (90%), fails everywhere (5%) or is
    skipped everywhere (5%); r = 0.
  - OD_FLAKY: baseline passes and shuffle fails from run r on, or
    baseline fails and shuffle passes from run r on.
  - FLAKY (NOD): baseline passes before run r and fails from it on, or
    fails before run r and passes from it on; shuffle passes.

- testinspect artifacts, ``<proj>_testinspect_0.{sqlite3,tsv,pkl}``:
  coverage in the coverage.py 5.x schema with numbits blobs, the rusage
  TSV (feature columns 3-8, written with ``str``) and the pickle
  ``(fn_ids, fn_data, test_files, churn)`` (columns 9-15; fn ids from 1).

The coverage rule. Columns 0-2 are covered lines, covered changes and
source covered lines, and source lines cannot exceed covered lines, so
they cannot always equal the synthetic values. Each test covers
``src = c2`` lines of its own source file ``pkg/mod_{j:04d}.py`` and
``max(c0 - c2, 0)`` lines of its own test file ``tests/cov_{j:04d}.py``
(listed in ``test_files``), or one line of the test file when that makes
no line at all; each range starts at a seeded line in [1, 16]. The
changes c1 are the churn of the first covered line, in the source file
when it has lines, else in the test file. So the expected row reads
``(src + tst, c1, src)``. A project whose tests have no churn at all gets
one churn entry on a line no test covers (``setup.py`` line 1), since an
empty churn dict drops the project.

Every project also holds three tests that the collation must drop, and
which the expected ``tests.json`` leaves out: ``test_partial`` (absent
from the last baseline run), ``test_unmeasured`` (absent from the
testinspect artifacts) and ``test_fid0`` (mapped to fn id 0, which the
reference's falsy filter drops).
"""

import os
import pickle
import random
import sqlite3
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

NON_FLAKY, OD_FLAKY, FLAKY = 0, 1, 2
DROPPED = ("test_partial", "test_unmeasured", "test_fid0")


def numbits(lines):
    """A coverage.py numbits blob of an int array of line numbers."""
    bits = np.zeros(int(lines.max()) + 1, dtype=bool)
    bits[lines] = True
    return np.packbits(bits, bitorder="little").tobytes()


def _outcomes(label, r, variant, n_runs):
    """{mode: (before, after, threshold)} for one test."""
    nb, ns = n_runs["baseline"], n_runs["shuffle"]
    p, f, s = "passed", "failed", "skipped"
    if label == NON_FLAKY:
        o = (p, f, s)[variant]
        return {"baseline": (o, o, nb), "shuffle": (o, o, ns)}
    if label == OD_FLAKY:
        if variant == 0:
            return {"baseline": (p, p, nb), "shuffle": (p, f, r)}
        return {"baseline": (f, f, nb), "shuffle": (f, p, r)}
    if variant == 0:
        return {"baseline": (p, f, r), "shuffle": (p, p, ns)}
    return {"baseline": (f, p, r), "shuffle": (p, p, ns)}


def _write(path, text):
    with open(path, "w") as fd:
        fd.write(text)


def _project(data_dir, subjects_dir, proj, feats, labels, n_runs, rs, pool):
    """Write one project's artifacts, the runs TSVs through the thread
    ``pool`` (file creation, not the text, is most of their cost on some
    filesystems); return (expected rows, files, outcome lines)."""
    n = len(labels)
    pending = []
    root = os.path.join(subjects_dir, proj, proj)
    nids = [f"tests/test_{proj}.py::test_{j:04d}" for j in range(n)]
    extra = [f"tests/test_{proj}.py::{name}" for name in DROPPED]

    req = np.zeros(n, dtype=np.int64)
    variant = np.zeros(n, dtype=np.int64)
    for j, lab in enumerate(labels):
        if lab == NON_FLAKY:
            variant[j] = rs.choice(3, p=(0.9, 0.05, 0.05))
        else:
            deciding = n_runs["shuffle" if lab == OD_FLAKY else "baseline"]
            req[j] = rs.randint(1, deciding)
            variant[j] = rs.randint(2)
    steps = [_outcomes(lab, req[j], variant[j], n_runs)
             for j, lab in enumerate(labels)]

    n_files = n_lines = 0
    for mode in ("baseline", "shuffle"):
        passed = [f"passed\t{nid}\n" for nid in extra]
        before, after = (
            np.array([f"{st[mode][i]}\t{nid}\n"
                      for st, nid in zip(steps, nids)] + passed, dtype=object)
            for i in (0, 1))
        thresh = np.array([st[mode][2] for st in steps]
                          + [n_runs[mode]] * len(extra))
        if mode == "baseline":
            after[n] = ""                      # test_partial: not in the last
            thresh[n] = n_runs[mode] - 1       # baseline run
        for k in range(n_runs[mode]):
            lines = np.where(k < thresh, before, after)
            if mode == "shuffle":
                lines = lines[rs.permutation(len(lines))]
            text = "".join(lines)
            pending.append(pool.submit(
                _write, os.path.join(data_dir, f"{proj}_{mode}_{k}.tsv"),
                text))
            n_files += 1
            n_lines += text.count("\n")

    for f in pending:
        f.result()

    # testinspect: every test but test_unmeasured.
    c0, c1, c2 = (np.rint(feats[:, i]).astype(np.int64) for i in range(3))
    src = c2
    tst = np.maximum(c0 - c2, 0)
    tst[src + tst == 0] = 1
    start = rs.randint(1, 17, size=(n, 2))
    measured = nids + [extra[0], extra[2]]
    cov = {}           # nid -> [(relative path, line array)]
    churn = {}
    test_files = set()
    for j, nid in enumerate(nids):
        parts = []
        for rel, k, s0 in ((f"pkg/mod_{j:04d}.py", src[j], start[j, 0]),
                           (f"tests/cov_{j:04d}.py", tst[j], start[j, 1])):
            if k:
                parts.append((rel, np.arange(s0, s0 + k)))
        test_files.add(f"tests/cov_{j:04d}.py")
        if c1[j]:
            rel, lines = parts[0]
            churn[rel] = {int(lines[0]): int(c1[j])}
        cov[nid] = parts
    # The dropped tests cover what test_0000 covers.
    cov[extra[0]] = cov[extra[2]] = cov[nids[0]]
    if not churn:
        churn["setup.py"] = {1: 1}

    path = os.path.join(data_dir, f"{proj}_testinspect_0")
    con = sqlite3.connect(path + ".sqlite3")
    con.executescript(
        "CREATE TABLE context (id INTEGER PRIMARY KEY, context TEXT);"
        "CREATE TABLE file (id INTEGER PRIMARY KEY, path TEXT);"
        "CREATE TABLE line_bits (file_id INTEGER, context_id INTEGER,"
        "                        numbits BLOB);")
    file_ids, rows = {}, []
    for ctx, nid in enumerate(measured, start=1):
        for rel, lines in cov[nid]:
            if rel not in file_ids:
                file_ids[rel] = len(file_ids) + 1
            rows.append((file_ids[rel], ctx, numbits(lines)))
    con.executemany("INSERT INTO context VALUES (?, ?)",
                    list(enumerate(measured, start=1)))
    con.executemany("INSERT INTO file VALUES (?, ?)",
                    [(i, os.path.join(root, rel))
                     for rel, i in file_ids.items()])
    con.executemany("INSERT INTO line_bits VALUES (?, ?, ?)", rows)
    con.commit()
    con.close()

    rusage = feats[:, 3:9].tolist()
    rusage_rows = rusage + [rusage[0], rusage[0]]
    with open(path + ".tsv", "w") as fd:
        for nid, vals in zip(measured, rusage_rows):
            fd.write("\t".join(str(v) for v in vals) + f"\t{nid}\n")

    fn_ids = {nid: j + 1 for j, nid in enumerate(nids)}
    fn_ids[extra[0]] = 1
    fn_ids[extra[2]] = 0
    fn_data = {j + 1: tuple(feats[j, 9:16].tolist()) for j in range(n)}
    fn_data[0] = fn_data[1]
    with open(path + ".pkl", "wb") as fd:
        pickle.dump((fn_ids, fn_data, test_files, churn), fd)
    n_files += 3

    expected = {
        nid: [int(req[j]), int(labels[j]), int(src[j] + tst[j]), int(c1[j]),
              int(src[j]), *rusage[j], *fn_data[j + 1]]
        for j, nid in enumerate(nids)}
    return expected, n_files, n_lines


def write_data_dir(data_dir, dataset, n_runs, subjects_dir, seed=0):
    """Write the artifacts of ``dataset`` = (feats [N, 16], labels [N],
    project_ids [N]), as ``utils.synth.make_dataset`` returns it, into
    ``data_dir`` (created), with coverage paths under ``subjects_dir``.
    Returns (the expected tests.json dict, {"files", "outcome_lines"})."""
    feats, labels, project_ids = (np.asarray(a) for a in dataset)
    os.makedirs(data_dir, exist_ok=True)
    rs = np.random.RandomState(seed)
    expected = {}
    n_files = n_lines = 0
    with ThreadPoolExecutor(max_workers=8) as pool:
        for pid in np.unique(project_ids):
            rows = np.flatnonzero(project_ids == pid)
            proj = f"project{pid:02d}"
            tests, files, lines = _project(
                data_dir, subjects_dir, proj, feats[rows], labels[rows],
                n_runs, rs, pool)
            expected[proj] = dict(sorted(tests.items(),
                                         key=lambda kv: kv[0].lower()))
            n_files += files
            n_lines += lines
    expected = dict(sorted(expected.items(), key=lambda kv: kv[0].lower()))
    return expected, {"files": n_files, "outcome_lines": n_lines}


GIT_ENV = {"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
           "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t"}


def git_commit_all(path, message="c1"):
    """``git init`` (if needed), add everything and commit."""
    env = {**os.environ, **GIT_ENV}
    if not os.path.isdir(os.path.join(path, ".git")):
        subprocess.run(["git", "init", "-q"], cwd=path, check=True,
                       capture_output=True, env=env)
    for args in (["add", "-A"], ["commit", "-qm", message]):
        subprocess.run(["git", *args], cwd=path, check=True,
                       capture_output=True, env=env)


def make_chain_subject(checkout):
    """The toy subject of the chain (28 tests): a dependency setter
    ``test_aa_dep``, 14 stable tests, 12 tests that fail on odd run
    numbers (NOD) and ``test_zz_od``, which passes only after
    ``test_aa_dep`` ran (OD). Bodies vary, so static features differ per
    test. Written and committed as a git checkout."""
    os.makedirs(checkout, exist_ok=True)
    with open(os.path.join(checkout, "pytest.ini"), "w") as fd:
        fd.write("[pytest]\n")
    src = ["import os", "", "RAN_DEP = False", "",
           "def test_aa_dep():",
           "    global RAN_DEP", "    RAN_DEP = True", "    assert True",
           ""]
    for i in range(14):
        src += [f"def test_stable_{i:02d}():",
                f"    vals = [v * {i + 1} for v in range({i + 2})]",
                f"    assert len(vals) == {i + 2}", ""]
    for i in range(12):
        src += [f"def test_nod_{i:02d}():",
                f"    pad = sum(range({i + 3}))",
                "    assert pad >= 0",
                "    assert int(os.environ['TOY_RUN']) % 2 == 0", ""]
    src += ["def test_zz_od():", "    assert RAN_DEP", ""]
    with open(os.path.join(checkout, "test_suite.py"), "w") as fd:
        fd.write("\n".join(src))
    git_commit_all(checkout)


def chain_shuffle_seeds(n_items=28):
    """Two shuffle seeds of the showflakes plugin's private RNG over the
    chain subject's items: with the first, ``test_zz_od`` (the last item)
    runs before ``test_aa_dep`` (the first); with the second, after."""
    def od_first(seed):
        idx = list(range(n_items))
        random.Random(seed).shuffle(idx)
        return idx.index(n_items - 1) < idx.index(0)

    return [next(s for s in range(100) if od_first(s)),
            next(s for s in range(100) if not od_first(s))]


def run_pytest(checkout, args, repo, env_extra=()):
    """``python -m pytest -q ARGS`` in ``checkout`` with ``repo`` on
    PYTHONPATH; returns the CompletedProcess."""
    env = dict(os.environ)
    env["PYTHONPATH"] = repo
    env.pop("PYTEST_ADDOPTS", None)
    env.update(env_extra)
    return subprocess.run([sys.executable, "-m", "pytest", "-q", *args],
                          cwd=checkout, env=env, capture_output=True,
                          text=True, timeout=300)


def collect(checkout, data_dir, proj, plugin_args, repo, shuffle_seeds,
            n_baseline=4):
    """A collection campaign on ``checkout``, as the containers run it:
    ``n_baseline`` baseline runs (``TOY_RUN`` = the run number), one
    shuffle run per seed (``SHOWFLAKES_SEED``), one testinspect run, each
    with ``plugin_args`` and ``--set-exitstatus``, writing
    ``<proj>_<mode>_<k>.*`` into ``data_dir``. Raises if a run fails."""
    runs = [("baseline", k, {}) for k in range(n_baseline)]
    runs += [("shuffle", k, {"SHOWFLAKES_SEED": str(seed)})
             for k, seed in enumerate(shuffle_seeds)]
    runs.append(("testinspect", 0, {}))
    for mode, k, env in runs:
        base = os.path.join(data_dir, f"{proj}_{mode}_{k}")
        if mode == "testinspect":
            flags = [f"--testinspect={base}"]
        else:
            flags = [f"--record-file={base}.tsv"]
            if mode == "shuffle":
                flags.append("--shuffle")
        r = run_pytest(checkout, [*plugin_args, "--set-exitstatus", *flags],
                       repo, {"TOY_RUN": str(k), **env})
        if r.returncode != 0:
            raise RuntimeError(f"{mode} run {k} exited {r.returncode}:\n"
                               + r.stdout[-2000:] + r.stderr[-2000:])
