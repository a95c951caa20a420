"""The sklearn parity oracle: the port's copy of the machinery of the root
``parity.py``, without sklearn.

The study's bar is per-config F1 within +/-0.01 of the sklearn stack on
the three ``scores`` probe configs. Both stacks carry randomness that the
other cannot replay, so the comparison is between seed-averaged means:
for each config, ours mean +/- sd over ``k_ours`` engine seeds, sklearn
mean +/- sd over ``k_sk`` seeds, their difference and its standard
error. The ensembles run on the histogram grower and the single Decision
Tree on the exact grower (the sweep's tier rule), and a Decision Tree
config without SMOTE is deterministic, so it runs one seed.

sklearn's side comes only from a committed cache, which records every
dataset parameter it was made under: ``parity_sklearn_n4000_t100.json``
at the repo root (N = 4000, 100 trees, 6 seeds, data seed 7), made by
the root ``parity.py --gen-cache``. A cache is read and never written;
one whose parameters differ from the run's, or that holds too few seeds
for a config, is refused, and a missing one raises. There is no
recompute: the card's machine has no sklearn.

``python -m flake16_framework_tpu_torch.perf.parity --full [--device
cpu] [--out PATH]`` runs the full tier on the card (or the CPU) and
prints one JSON line a config and the verdict, and exits 1 when a delta
is past the tolerance. ``--out`` writes the whole record to PATH; the
root's ``PARITY.json`` belongs to the JAX package and is never written.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE = os.path.join(REPO, "parity_sklearn_n4000_t100.json")
TOLERANCE = 0.01

# The full tier and the dataset it was cached under (root ``parity.py``).
FULL = dict(n_tests=4000, n_trees=100, k_ours=6, k_sk=6)
DATA = dict(data_seed=7, nod_bump=2.5, od_bump=1.8, noise_sigma=0.35)

# The three ``scores`` probe configs of the study's baseline.
PROBE_CONFIGS = [
    ("NOD", "Flake16", "None", "None", "Decision Tree"),
    ("NOD", "Flake16", "Scaling", "SMOTE", "Random Forest"),
    ("OD", "Flake16", "PCA", "SMOTE Tomek", "Extra Trees"),
]


def _f1_from_conf(fp, fn, tp):
    prec = tp / (tp + fp) if tp + fp else None
    rec = tp / (tp + fn) if tp + fn else None
    if not prec or not rec:
        return 0.0
    return 2 * prec * rec / (prec + rec)


def ours_config_f1s(feats, labels, pids, keys, *, n_trees, seeds,
                    grower=None, device=None):
    """The port's sweep for one config across ``seeds``: one engine on
    ``device`` (``device.resolve``: the card unless the caller asks for
    the CPU), ``engine.seed`` set before each run, as the root
    ``parity.ours_config_f1s`` varies the JAX engine's. ``grower`` is the
    ensembles' grower (``trees.ensemble_grower``)."""
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine

    names = [f"project{p:02d}" for p in range(int(pids.max()) + 1)]
    projects = np.array([names[p] for p in pids])
    engine = SweepEngine(
        feats, labels, projects, names, pids,
        tree_overrides={"Random Forest": n_trees, "Extra Trees": n_trees},
        grower=grower, device=device)
    out = []
    for s in seeds:
        engine.seed = s
        out.append(_f1_from_conf(*engine.run_config(keys)[3][:3]))
    return out


def load_cache(path, params):
    """The cache at ``path``, refused (ValueError, in the root
    ``parity.py``'s words) unless it records every parameter of
    ``params`` at this run's value. A missing file raises."""
    with open(path) as fd:
        c = json.load(fd)
    for name, val in params.items():
        if name not in c:
            raise ValueError(
                f"sklearn cache lacks {name!r} — regenerate it (old caches "
                "without recorded dataset params are not trusted)")
        if c[name] != val:
            raise ValueError(
                f"sklearn cache {name}={c[name]} != this run's {val}")
    return c


def run_parity(*, n_tests, n_trees, k_ours, k_sk, sklearn_cache,
               data_seed=7, nod_bump=2.5, od_bump=1.8, noise_sigma=0.35,
               configs=None, device=None, log=None):
    """Seed-averaged F1 of the port against the sklearn cache
    (``load_cache``), a report dict a config: ours and sklearn mean, sd
    and seed count, ``delta`` and ``se_delta``, the ``grower`` that
    measured the row and the row's ``wall_s``. ``log(line)`` gets each
    row's JSON line as it lands."""
    from flake16_framework_tpu_torch.utils.synth import make_dataset

    params = dict(n_tests=n_tests, n_trees=n_trees, data_seed=data_seed,
                  nod_bump=nod_bump, od_bump=od_bump,
                  noise_sigma=noise_sigma)
    cache = load_cache(sklearn_cache, params)
    feats, labels, pids = make_dataset(
        n_tests=n_tests, seed=data_seed, nod_bump=nod_bump, od_bump=od_bump,
        noise_sigma=noise_sigma)
    report = {}
    for keys in (configs or PROBE_CONFIGS):
        deterministic = keys[4] == "Decision Tree" and "SMOTE" not in keys[3]
        sk = cache["f1s"]["/".join(keys)]
        if len(sk) < max(k_sk, 2):
            raise ValueError(
                f"cache has {len(sk)} seeds for {keys}, need {k_sk}")
        # at least 2 seeds: std(ddof=1) of one value would be nan
        s = np.array(sk[:max(k_sk, 2)])
        t0 = time.time()
        # grower="hist" explicitly: the criterion row is the shipped tier
        o = np.array(ours_config_f1s(
            feats, labels, pids, keys, n_trees=n_trees,
            seeds=range(1 if deterministic else k_ours), grower="hist",
            device=device))
        se = float(np.sqrt(
            (o.std(ddof=1) ** 2 / len(o) if len(o) > 1 else 0.0)
            + s.std(ddof=1) ** 2 / len(s)))
        entry = {
            "ours_mean": round(float(o.mean()), 4),
            "ours_sd": round(float(o.std()), 4),
            "ours_k": len(o),
            "sklearn_mean": round(float(s.mean()), 4),
            "sklearn_sd": round(float(s.std()), 4),
            "sklearn_k": len(s),
            "delta": round(float(o.mean() - s.mean()), 4),
            "se_delta": round(se, 4),
            "grower": "exact" if keys[4] == "Decision Tree" else "hist",
            "ours_f1s": [float(v) for v in o],
            "wall_s": round(time.time() - t0, 3),
        }
        report["/".join(keys)] = entry
        if log is not None:
            log(json.dumps({keys[4]: entry}))
    return report


def full_record(report, device):
    """The full tier's record: the rows, the tolerance and the verdict
    (``ok``: every delta within it)."""
    return {"tier": "full", **FULL, "tolerance": TOLERANCE,
            "configs": report, "ours_device": str(device),
            "criterion_tier": "hist-ensembles",
            "ok": all(abs(v["delta"]) <= TOLERANCE
                      for v in report.values())}


def main(argv=None, out=None):
    """The ``--full`` tier: the port against the committed ``CACHE`` on
    ``--device``; one JSON line a config, the verdict line, exit 1 on a
    miss."""
    from flake16_framework_tpu_torch.device import resolve
    from flake16_framework_tpu_torch.utils.atomic import atomic_write_bytes

    out = out or sys.stdout
    ap = argparse.ArgumentParser(
        prog="python -m flake16_framework_tpu_torch.perf.parity")
    ap.add_argument("--full", action="store_true",
                    help="the assertion tier: N = 4000, 100 trees, 6 seeds")
    ap.add_argument("--device", default=None, help="cuda (the default) "
                    "or cpu")
    ap.add_argument("--out", default=None,
                    help="write the whole record here as JSON")
    args = ap.parse_args(argv)
    if not args.full:
        ap.error("only --full runs here: the small tier computes sklearn's "
                 "side, and the port has no sklearn")
    device = resolve(args.device)

    def log(line):
        out.write(line + "\n")
        out.flush()

    record = full_record(run_parity(
        n_tests=FULL["n_tests"], n_trees=FULL["n_trees"],
        k_ours=FULL["k_ours"], k_sk=FULL["k_sk"], sklearn_cache=CACHE,
        device=device, log=log, **DATA), device)
    if args.out:
        atomic_write_bytes(args.out, json.dumps(record, indent=2).encode())
    log(json.dumps({"parity_ok": record["ok"], "tolerance": TOLERANCE}))
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
