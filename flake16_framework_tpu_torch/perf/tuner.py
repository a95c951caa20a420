"""The bench-in-the-loop autotuner, a copy of the JAX package's
``perf/tuner.py`` over the knobs the port reads.

- **KnobSpace** — the typed registry of every tunable: env var, value
  domain, shape-applicability predicate, and the results-neutral vs
  parity-affecting flag. The lint's G108 audits kernel-path constants
  against this registry (a tunable constant without a registration is a
  finding), and parity-affecting winners must re-pass a parity oracle
  before acceptance.
- **Search** — per (backend, plan-shape, model family): successive
  halving over short probes (each candidate runs the REAL engine on the
  probe configs in a fresh child process), repetitions doubling as the
  field halves, then a compose rung that merges each knob's best value.
  The perfdb seeds it: recorded history sizes the probe timeout, and
  audit memory envelopes veto widths whose scaled working set would
  blow the memory cap.
- **Persistence** — winners land as ``tuned`` perfdb rows keyed
  per-model (``obs/perfdb.model_kernel``) at
  ``perfdb.shape_sig(planner.plan_shape(...))``, which is what
  ``tuned_fit_overrides`` looks up when ``scores planner`` plans. Absent
  rows keep execution at today's defaults.

What differs from the JAX package's tuner:

- **KNOBSPACE registers only the knobs the port reads**, over the
  values the port can run: the hist grower's window width,
  ``F16_HIST_NODE_BATCH_CPU`` on the CPU and ``F16_HIST_NODE_BATCH`` on
  the card (``ops/trees.default_node_batch``; the device predicate is
  ``backend == "cuda"`` where the JAX package's is ``backend !=
  "cpu"``), and the histogram resolution ``F16_HIST_BINS`` (``32 48
  64``, default 64, parity-affecting, ensembles only, as in the JAX
  package; ``ops/trees.hist_bins``). The card's width domain is ``64
  128`` where the JAX package's is ``64 128 256``: at the default 64
  bins K1's histogram holds at most 226 nodes in a block's shared
  memory (``kernels/hist.max_window``), so the grower raises for 256
  and a probe of it could only come back ``inf``. Two JAX registrations
  have no reader here and are not registered: ``F16_HIST_REFINE_TILE``
  (the port's refinement has no tile loop) and ``F16_SHAP_TREE_CHUNK``
  (the port's explain has no tree-chunk loop).
- **The probe** (``tune --probe``) runs the port's ``SweepEngine(...,
  planner_mode=True)`` on the family's configs from ``perf/probe.py``
  (the port's copy of ``bench.py``'s probe configs and data maker) on
  the device ``--backend`` names (``cuda`` by default). Its line also
  carries the K1/K2 launches of one timed run. The grower reads the
  width per call, not at import as the JAX package's does; each
  candidate still probes in a fresh child process, so that it gets its
  own CUDA context and allocator and its failure cannot take the search
  down. A probe whose configs the dispatch guard quarantines fails.
- **The parity oracle is the port's own** (``perf/parity.py``). The
  JAX package's ``parity_subprocess_check`` runs the root ``parity.py``
  small tier, which computes sklearn's side; the port has no sklearn,
  so its check runs ``perf/parity.py --full`` (N = 4000, 100 trees, 6
  seeds, against the committed sklearn cache) in a child under the
  candidate's env on the tuner's device. A winner that sets a
  parity-affecting knob is accepted only when that child exits 0.
  ``--no-parity-knobs`` searches the results-neutral knobs only, and
  ``--parity-timeout`` bounds the child, as in the JAX verb. Its
  ``--json`` is not accepted: the summary is always one JSON line.
- **Backend.** ``tune`` searches on ``cuda`` unless ``--backend cpu``
  asks for the CPU, and raises without CUDA (``device.resolve``): there
  is no silent CPU path.
- **The memory veto scales an envelope from its own width.** The JAX
  tuner scales every audit envelope by width / 8, its CPU audit's width.
  The port's audit records the width each envelope was measured at
  (``width``: 8 on the CPU, 128 on the card), and ``mem_vetoed`` scales
  from it (``audit_envelope`` picks the row with the largest peak per
  unit of width); a row without one (a JAX document) is scaled from 8
  under the JAX rule, so the veto is the JAX tuner's on its documents.
  ``tune --dry-run`` also prints the veto: the candidates it drops and,
  beside the field, the verdict at every width of the domain (``veto``).
- **A failed probe fails the verb.** As in the JAX package the failed
  candidate loses the search (its wall is ``inf``), but ``tune`` then
  exits 1, so a broken probe never passes as "defaults stand"; the
  summary lists every probe (``probes``) with its exit code.

Import-light on purpose: no torch at module load — the lint census,
tests, and the CLI's help path never touch a device.
"""

import json
import os
import subprocess
import sys
import time
from collections import namedtuple

from flake16_framework_tpu_torch.obs import perfdb
from flake16_framework_tpu_torch.parallel import planner

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

ENSEMBLES = ("Random Forest", "Extra Trees")

# One registered tunable. ``domain`` values are env-var STRINGS (the
# knob's transport is the environment); ``applies(shape, backend,
# model)`` gates candidates per (n, n_feat, n_trees, n_folds, cap) plan
# shape; ``parity_affecting`` knobs change model outputs and re-run the
# parity oracle before a winner is accepted (results-neutral knobs grow
# bit-identical forests by the grower contract and skip it).
Knob = namedtuple(
    "Knob", ["name", "domain", "default", "parity_affecting", "target",
             "applies", "note"])


def _cpu_hist(shape, backend, model):
    return backend == "cpu" and model in ENSEMBLES


def _device_hist(shape, backend, model):
    return backend == "cuda" and model in ENSEMBLES


def _hist_families(shape, backend, model):
    return model in ENSEMBLES


KNOBSPACE = (
    Knob("F16_HIST_NODE_BATCH_CPU", ("4", "6", "8", "12", "16"), "0",
         False, "fit", _cpu_hist,
         "CPU BFS window width of the hist grower; 0 keeps the grower's "
         "own (ops/trees.py NODE_BATCH)"),
    Knob("F16_HIST_NODE_BATCH", ("64", "128"), "128",
         False, "fit", _device_hist,
         "card BFS window width of the hist grower (K1's window)"),
    Knob("F16_HIST_BINS", ("32", "48", "64"), "64",
         True, "fit", _hist_families,
         "histogram resolution; candidate selection is bin-granular, so "
         "this MOVES model outputs — winners must re-pass parity"),
)


def knobspace(target=None):
    """The registry, optionally filtered by tuning target."""
    if target is None:
        return KNOBSPACE
    return tuple(k for k in KNOBSPACE if k.target == target)


def registered_env_names():
    """Env vars the KnobSpace declares — the set the lint's G108 accepts
    as 'this constant is tuner-managed'."""
    return frozenset(k.name for k in KNOBSPACE)


# -- candidate generation ------------------------------------------------


def applicable_knobs(shape, backend, model, *, target="fit", env=None,
                     include_parity=True):
    """Registry entries live for one (shape, backend, model) tuning run.
    A knob the operator already pinned in the environment is excluded —
    an explicit export outranks the search (same precedence the
    plan-time consult enforces, obs/perfdb.tuned_fit_overrides)."""
    env = os.environ if env is None else env
    out = []
    for k in knobspace(target):
        if k.name in env:
            continue
        if not include_parity and k.parity_affecting:
            continue
        if k.applies(tuple(shape), backend, model):
            out.append(k)
    return out


def candidates(knobs):
    """The deterministic rung-0 field: the baseline (today's defaults,
    empty env) plus every single-knob assignment, in registry order.
    Cross-knob composition happens AFTER the halving rungs (the compose
    rung merges each knob's surviving best value), so the field stays
    linear in the domain sizes instead of their product."""
    out = [("base", {})]
    for k in knobs:
        for v in k.domain:
            if str(v) == str(k.default):
                continue  # the baseline already measures the default
            out.append((f"{k.name}={v}", {k.name: str(v)}))
    return out


# -- perfdb seeding ------------------------------------------------------


def family_history_wall(rows, backend, n, n_trees, member_codes):
    """The best committed per-family fit wall (seconds) for this probe
    shape: per source document, the sum of its members' ``config.*``
    fit walls (falling back to total) — the history seed that sizes
    probe timeouts and the baseline expectation. None when the history
    carries nothing comparable."""
    sig = f"probe.n{n}.t{n_trees}"
    per_src = {}
    for row in rows or ():
        if row.get("backend") not in (backend, "*"):
            continue
        if row.get("shape") != sig:
            continue
        kernel = str(row.get("kernel") or "")
        if not kernel.startswith("config."):
            continue
        if kernel[len("config."):] not in member_codes:
            continue
        m = row.get("metrics") or {}
        wall = m.get("fit_s", m.get("total_s"))
        if not isinstance(wall, (int, float)):
            continue
        key = (row.get("src"), row.get("round"))
        per_src.setdefault(key, {})[kernel] = float(wall)
    sums = [sum(v.values()) for v in per_src.values()
            if len(v) == len(member_codes)]
    return min(sums) if sums else None


# The window width the JAX package's audit envelopes stand for: they
# record none, and the JAX tuner scales them from width 8.
WIDTH_OF_JAX_AUDIT = 8


def audit_envelope(rows):
    """(peak_mb, width) of the audit row (obs/perfdb.rows_from_audit)
    whose envelope is the largest per unit of window width — the
    width-veto anchor — or (None, None) with none on record. ``width`` is
    the row's ``width`` metric: the port's audit records the width each
    plan ran at (8 on the CPU, 128 on the card); the JAX package's rows
    carry none (None, read as ``WIDTH_OF_JAX_AUDIT``)."""
    best, best_ratio = (None, None), None
    for row in rows or ():
        if not str(row.get("kernel") or "").startswith("audit."):
            continue
        m = row.get("metrics") or {}
        peak, width = m.get("peak_mb"), m.get("width")
        if not isinstance(peak, (int, float)):
            continue
        if width is not None and (not isinstance(width, (int, float))
                                  or width <= 0):
            continue
        ratio = peak / (width or WIDTH_OF_JAX_AUDIT)
        if best_ratio is None or ratio > best_ratio:
            best, best_ratio = (float(peak), width), ratio
    return best


def audit_peak_mb(rows):
    """The anchor envelope's peak (``audit_envelope``): on the JAX
    package's rows, which carry no width, the largest plan envelope on
    record."""
    return audit_envelope(rows)[0]


# The window-width knobs, the ones the memory veto scales by.
WIDTH_KNOBS = ("F16_HIST_NODE_BATCH_CPU", "F16_HIST_NODE_BATCH")


def mem_vetoed(cand_env, peak_mb, cap_mb, audited_width=None):
    """Whether a candidate's window width would scale the audited plan
    envelope past the cap. The grower's per-step working set is ~linear
    in the width, so the envelope scales by width / the width it was
    audited at: ``audited_width``, the width the port's audit measured
    the envelope at, or None for the JAX package's envelopes, which stand
    for width 8 and, as in the JAX tuner, never veto a width at or under
    it. No envelope on record means no veto."""
    if peak_mb is None or not cap_mb:
        return False
    width = cand_env.get("F16_HIST_NODE_BATCH_CPU") or \
        cand_env.get("F16_HIST_NODE_BATCH")
    try:
        width = int(width)
    except (TypeError, ValueError):
        return False
    if audited_width is None and width <= WIDTH_OF_JAX_AUDIT:
        return False
    scale = width / float(audited_width or WIDTH_OF_JAX_AUDIT)
    return peak_mb * scale > cap_mb


def width_verdicts(knobs, peak_mb, cap_mb, audited_width=None):
    """{width: {"scaled_mb", "vetoed"}} for every width of the window
    knobs' domains, their defaults included, at the anchor envelope —
    what ``tune --dry-run`` prints beside the field. The field never drops
    the baseline (today's default width, an empty env), as in the JAX
    tuner; the verdict on the default says whether it fits the cap."""
    if peak_mb is None:
        return {}
    return {str(v): {
        "scaled_mb": round(peak_mb * int(v)
                           / float(audited_width or WIDTH_OF_JAX_AUDIT), 3),
        "vetoed": mem_vetoed({k.name: v}, peak_mb, cap_mb, audited_width)}
        for k in knobs if k.name in WIDTH_KNOBS for v in k.domain}


# -- the search ----------------------------------------------------------

TuneResult = namedtuple(
    "TuneResult", ["family", "shape", "winner", "winner_env", "wall_s",
                   "base_wall_s", "gain_pct", "walls", "rejected",
                   "recorded"])


def successive_halving(cands, measure, *, reps_schedule=(1, 2, 4),
                       keep=0.5, min_survivors=3, log=None):
    """Deterministic successive halving: every rung measures the
    surviving field at the rung's rep count (walls keep the running min
    across rungs — repetitions only ever sharpen), then keeps the best
    ``keep`` fraction, ties broken by candidate NAME so the same wall
    table always yields the same survivors (the determinism contract
    the tests pin). Returns {name: wall}."""
    alive = list(cands)
    walls = {}
    for rung, reps in enumerate(reps_schedule):
        for name, env in alive:
            w = measure(env, reps)
            walls[name] = min(walls.get(name, float("inf")), w)
        if log:
            log(f"  rung {rung} (reps={reps}): " + ", ".join(
                f"{n}={walls[n]:.2f}s" for n, _ in alive))
        if len(alive) <= min_survivors or rung == len(reps_schedule) - 1:
            break
        alive.sort(key=lambda c: (walls[c[0]], c[0]))
        alive = alive[:max(min_survivors, int(len(alive) * keep))]
    return walls


def compose_best(knobs, walls, base_wall):
    """The compose rung's candidate: each knob's best measured value
    among those that beat the baseline. Empty when no knob did."""
    env = {}
    for k in knobs:
        best_v, best_w = None, base_wall
        for v in k.domain:
            name = f"{k.name}={v}"
            w = walls.get(name)
            if w is not None and w < best_w:
                best_v, best_w = str(v), w
        if best_v is not None:
            env[k.name] = best_v
    return env


def tune_family(fs_name, model_name, *, backend, n, n_trees, n_folds,
                measure, rows=None, member_codes=(), include_parity=True,
                parity_check=None, min_gain_pct=2.0, cap_mb=3072.0,
                db=None, record=True, log=None):
    """Search one family's knob space and (optionally) record the winner
    as a tuned perfdb row. ``measure(env, reps) -> wall_s`` is the
    oracle (child-process probe in production, injected in tests);
    ``parity_check(env) -> bool`` guards parity-affecting winners —
    None with parity knobs in play means they are skipped up front
    (never accept what cannot be checked)."""
    log = log or (lambda *_: None)
    shape = planner.plan_shape(
        fs_name, model_name, n=n, n_folds=n_folds,
        tree_overrides={m: n_trees for m in ENSEMBLES})
    include_parity = include_parity and parity_check is not None
    knobs = applicable_knobs(shape, backend, model_name,
                             include_parity=include_parity)
    hist_wall = family_history_wall(rows, backend, n, n_trees,
                                    set(member_codes))
    peak_mb, audited_width = audit_envelope(rows)
    field = [(name, env) for name, env in candidates(knobs)
             if not mem_vetoed(env, peak_mb, cap_mb, audited_width)]
    vetoed = len(candidates(knobs)) - len(field)
    log(f"{fs_name}/{model_name}: {len(field)} candidate(s) over "
        f"{len(knobs)} knob(s)"
        + (f", {vetoed} width(s) vetoed by the {peak_mb:.0f} MB audit "
           f"envelope" if vetoed else "")
        + (f", history seed {hist_wall:.1f}s" if hist_wall else ""))

    walls = successive_halving(field, measure, log=log)
    base_wall = walls.get("base", float("inf"))

    composed = compose_best(knobs, walls, base_wall)
    if composed and len(composed) > 1:
        name = "+".join(f"{k}={v}" for k, v in sorted(composed.items()))
        walls[name] = measure(composed, 4)
        field.append((name, composed))
        log(f"  compose: {name}={walls[name]:.2f}s")

    by_env = dict(field)
    rejected = []

    def pick(pool):
        ranked = sorted(pool, key=lambda name: (walls[name], name))
        return ranked[0] if ranked else "base"

    winner = pick(list(walls))
    while winner != "base":
        env = by_env.get(winner, {})
        parity_knobs = [k for k in knobs if k.parity_affecting
                        and k.name in env]
        if not parity_knobs:
            break
        log(f"  parity re-check for {winner} "
            f"({', '.join(k.name for k in parity_knobs)})")
        if parity_check is not None and parity_check(env):
            break
        rejected.append({"candidate": winner, "reason": "parity",
                         "wall_s": walls[winner]})
        log(f"  REJECTED {winner}: parity oracle red")
        walls.pop(winner)
        winner = pick(list(walls))

    wall = walls.get(winner, float("inf"))
    gain = (100.0 * (base_wall - wall) / base_wall
            if base_wall not in (0.0, float("inf")) else 0.0)
    winner_env = dict(by_env.get(winner, {}))
    if winner == "base" or gain < min_gain_pct or not winner_env:
        log(f"  no winner past the {min_gain_pct:.1f}% gain floor "
            f"(best {winner}: {gain:+.1f}%) — defaults stand, no row")
        return TuneResult((fs_name, model_name), shape, "base", {},
                          base_wall, base_wall, 0.0, walls, rejected,
                          None)

    recorded = None
    if record:
        metrics = {"fit_s": round(wall, 4),
                   "base_fit_s": round(base_wall, 4),
                   "gain_pct": round(gain, 2)}
        recorded = perfdb.record_tuned(
            backend, perfdb.shape_sig(shape),
            perfdb.model_kernel(model_name), winner_env, metrics,
            path=db)
    log(f"  WINNER {winner}: {wall:.2f}s vs base {base_wall:.2f}s "
        f"({gain:+.1f}%)" + (" — recorded" if recorded else ""))
    return TuneResult((fs_name, model_name), shape, winner, winner_env,
                      wall, base_wall, gain, walls, rejected, recorded)


# -- the production oracle -----------------------------------------------


def _probe_env(cand_env):
    env = dict(os.environ)
    env.update(cand_env)
    # Probes measure the CANDIDATE env, never the database: a tuned row
    # sneaking into a probe would make the search self-referential.
    env["F16_PERFDB"] = "0"
    return env


def subprocess_measure(fs_name, model_name, *, backend, n, n_trees,
                       timeout_s, py=None, log=None):
    """The production oracle: each candidate probes in a FRESH child
    process (``tune --probe --backend BACKEND``): its own CUDA context
    and allocator, and a failure that cannot take the search down.
    Failure/timeout returns inf (the candidate loses). Every probe is
    kept in the returned callable's ``probes`` list: {"candidate",
    "reps", "rc", "wall_s", "walls", "launches", "knobs"} (rc None and
    wall_s None on a timeout, wall_s None when no probe line came
    back)."""
    py = py or sys.executable
    probes = []

    def measure(cand_env, reps):
        cmd = [py, "-m", "flake16_framework_tpu_torch", "tune", "--probe",
               "--family", f"{fs_name}/{model_name}",
               "--n", str(n), "--trees", str(n_trees),
               "--reps", str(max(1, int(reps))), "--backend", backend]
        probe = {"candidate": dict(cand_env), "reps": max(1, int(reps)),
                 "rc": None, "wall_s": None, "walls": None,
                 "launches": None, "knobs": None}
        probes.append(probe)
        try:
            proc = subprocess.run(
                cmd, cwd=REPO, env=_probe_env(cand_env),
                capture_output=True, text=True, timeout=timeout_s)
        except subprocess.TimeoutExpired:
            if log:
                log(f"  probe timeout ({timeout_s:.0f}s): {cand_env}")
            return float("inf")
        probe["rc"] = proc.returncode
        for line in reversed((proc.stdout or "").strip().splitlines()):
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "wall_s" in rec:
                probe.update(wall_s=float(rec["wall_s"]),
                             walls=rec.get("walls"),
                             launches=rec.get("launches"),
                             knobs=rec.get("knobs"))
                return float(rec["wall_s"])
        if log:
            tail = (proc.stderr or "").strip().splitlines()[-3:]
            log(f"  probe failed rc={proc.returncode}: {cand_env} "
                f"{' | '.join(tail)}")
        return float("inf")

    measure.probes = probes
    return measure


def parity_subprocess_check(backend, *, timeout_s=3600, py=None,
                            log=None):
    """Parity oracle for parity-affecting winners: the port's full tier
    (``python -m flake16_framework_tpu_torch.perf.parity --full --device
    BACKEND``) in a child under the candidate env. Exit 0 is green. A
    timeout or any other exit is red: never accept what did not provably
    pass."""
    py = py or sys.executable

    def check(cand_env):
        t0 = time.time()
        try:
            proc = subprocess.run(
                [py, "-m", "flake16_framework_tpu_torch.perf.parity",
                 "--full", "--device", backend], cwd=REPO,
                env=_probe_env(cand_env), capture_output=True, text=True,
                timeout=timeout_s)
        except subprocess.TimeoutExpired:
            if log:
                log(f"  parity TIMEOUT ({timeout_s:.0f}s) under "
                    f"{cand_env}")
            return False
        if log:
            log(f"  parity {'green' if proc.returncode == 0 else 'RED'} "
                f"in {time.time() - t0:.0f}s under {cand_env}")
        return proc.returncode == 0

    return check


def probe_failed(probe):
    """Whether a ``subprocess_measure`` probe failed: a timeout, a
    nonzero exit, or no finite wall."""
    wall = probe.get("wall_s")
    return (probe.get("rc") != 0 or wall is None
            or wall in (float("inf"), float("-inf")) or wall != wall)


# -- CLI -----------------------------------------------------------------


def run_probe(fs_name, model_name, n, n_trees, reps, backend=None,
              out=None):
    """``tune --probe`` body (runs inside the candidate's env): warm the
    family's probe configs through the real engine (the plan executor,
    as ``scores planner`` runs them), then report the min steady-state
    wall over ``reps`` whole-family runs and the K1/K2 launches of one
    timed run. A config the dispatch guard quarantines fails the probe."""
    import torch

    from flake16_framework_tpu_torch.device import resolve
    from flake16_framework_tpu_torch.kernels.build import launch_counts
    from flake16_framework_tpu_torch.parallel.sweep import SweepEngine
    from flake16_framework_tpu_torch.perf import probe

    out = out or sys.stdout
    dev = resolve(backend)
    fam = [k for k in probe.CONFIGS if (k[1], k[4]) ==
           (fs_name, model_name)]
    if not fam:
        raise ValueError(f"no probe configs for family "
                         f"{fs_name}/{model_name}")
    feats, labels, projects, names, pids = probe.make_data(n)
    engine = SweepEngine(feats, labels, projects, names, pids,
                         tree_overrides={m: n_trees for m in ENSEMBLES},
                         planner_mode=True, device=dev)

    def run():
        got = engine.run_grid(fam)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if engine.quarantined or len(got) != len(fam):
            raise RuntimeError(f"probe {fs_name}/{model_name}: configs "
                               f"quarantined {sorted(engine.quarantined)}")

    run()  # warm-up: kernel loads, allocator, first-touch
    walls, launches = [], None
    for _ in range(max(1, reps)):
        before = launch_counts()
        t0 = time.time()
        run()
        walls.append(round(time.time() - t0, 4))
        after = launch_counts()
        launches = {"hist_cumsum": after["k1_launches"]
                    - before["k1_launches"],
                    "treeshap_unit": after["k2_launches"]
                    - before["k2_launches"]}
    out.write(json.dumps({
        "probe": f"{fs_name}/{model_name}", "n": n, "trees": n_trees,
        "wall_s": min(walls), "walls": walls,
        "backend": dev.type, "launches": launches,
        "knobs": perfdb.knob_snapshot(),
    }) + "\n")
    out.flush()
    return 0


def _probe_families():
    from flake16_framework_tpu_torch.perf import probe

    fams, codes = [], {}
    for keys in probe.CONFIGS:
        fam = (keys[1], keys[4])
        if fam[1] in ENSEMBLES and fam not in fams:
            fams.append(fam)
        codes.setdefault(fam, []).append("/".join(keys))
    return fams, codes


def tune_main(argv, out=None):
    """CLI entry for the ``tune`` verb (__main__.py). Returns an exit
    code: 0 when every probe ran (even when every family keeps its
    defaults — 'nothing beat the baseline' is a valid tuning outcome),
    1 when a probe failed."""
    import argparse

    from flake16_framework_tpu_torch.device import resolve
    from flake16_framework_tpu_torch.perf import probe

    out = out or sys.stdout
    ap = argparse.ArgumentParser(
        prog="python -m flake16_framework_tpu_torch tune", add_help=True)
    ap.add_argument("--probe", action="store_true",
                    help="internal: measure ONE candidate in-process")
    ap.add_argument("--family", help="Feature set/Model (probe or "
                    "restrict tuning to one family)")
    ap.add_argument("--n", type=int, default=None,
                    help="probe rows (default: BENCH_FB_N_TESTS, 400)")
    ap.add_argument("--trees", type=int, default=None)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--backend", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--db", default=None, help="perfdb path override")
    ap.add_argument("--min-gain", type=float, default=2.0,
                    help="%% fit-wall gain a winner must clear")
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-probe child-process timeout (s)")
    ap.add_argument("--parity-timeout", type=float, default=3600.0)
    ap.add_argument("--no-parity-knobs", action="store_true",
                    help="search results-neutral knobs only")
    ap.add_argument("--mem-cap-mb", type=float, default=3072.0)
    ap.add_argument("--dry-run", action="store_true",
                    help="print the candidate field, run nothing")
    args = ap.parse_args(argv)

    n = args.n if args.n is not None else probe.FB_N_TESTS
    n_trees = args.trees if args.trees is not None else probe.FB_N_TREES

    if args.probe:
        if not args.family or "/" not in args.family:
            raise ValueError("--probe needs --family 'FeatureSet/Model'")
        fs_name, model_name = args.family.split("/", 1)
        return run_probe(fs_name, model_name, n, n_trees, args.reps,
                         backend=args.backend, out=out)

    # cuda unless the caller asks for the CPU; raises without CUDA.
    backend = resolve(args.backend).type
    fams, codes = _probe_families()
    if args.family:
        fs_name, model_name = args.family.split("/", 1)
        fams = [f for f in fams if f == (fs_name, model_name)]
        if not fams:
            raise ValueError(f"unknown tuning family {args.family!r}")

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    # Seed context: the perfdb (history + audit envelope rows). Absent/
    # unreadable databases seed nothing.
    db_path = perfdb.default_db(args.db)
    rows = []
    if db_path and os.path.isfile(db_path):
        try:
            rows = perfdb.load(db_path)
        except Exception:
            rows = []

    summary = {"verb": "tune", "backend": backend, "n": n,
               "trees": n_trees, "db": db_path, "families": {},
               "env": {}}
    n_folds = 10  # the study protocol's StratifiedKFold(10)

    if args.dry_run:
        peak_mb, audited_width = audit_envelope(rows)
        summary["envelope"] = {"peak_mb": peak_mb, "width": audited_width,
                               "cap_mb": args.mem_cap_mb}
        summary["veto"] = {}
        for fam in fams:
            shape = planner.plan_shape(
                *fam, n=n, n_folds=n_folds,
                tree_overrides={m: n_trees for m in ENSEMBLES})
            knobs = applicable_knobs(
                shape, backend, fam[1],
                include_parity=not args.no_parity_knobs)
            field = candidates(knobs)
            summary["families"]["/".join(fam)] = {
                "shape": perfdb.shape_sig(shape),
                "candidates": [name for name, _ in field],
            }
            # The audit envelope's memory veto: which candidates the
            # search would drop, and the verdict at every width.
            summary["veto"]["/".join(fam)] = {
                "vetoed": [name for name, env in field if mem_vetoed(
                    env, peak_mb, args.mem_cap_mb, audited_width)],
                "widths": width_verdicts(knobs, peak_mb, args.mem_cap_mb,
                                         audited_width),
            }
        out.write(json.dumps(summary) + "\n")
        return 0

    parity_check = None if args.no_parity_knobs else \
        parity_subprocess_check(backend, timeout_s=args.parity_timeout,
                                log=log)
    failed = 0
    for fam in fams:
        fs_name, model_name = fam
        hist = family_history_wall(rows, backend, n, n_trees,
                                   set(codes.get(fam, ())))
        timeout_s = args.timeout or max(300.0, 6.0 * (hist or 120.0))
        measure = subprocess_measure(
            fs_name, model_name, backend=backend, n=n, n_trees=n_trees,
            timeout_s=timeout_s, log=log)
        res = tune_family(
            fs_name, model_name, backend=backend, n=n, n_trees=n_trees,
            n_folds=n_folds, measure=measure, rows=rows,
            member_codes=codes.get(fam, ()),
            include_parity=not args.no_parity_knobs,
            parity_check=parity_check, min_gain_pct=args.min_gain,
            cap_mb=args.mem_cap_mb, db=args.db, log=log)
        bad = [p for p in measure.probes if probe_failed(p)]
        failed += len(bad)
        summary["families"]["/".join(fam)] = {
            "winner": res.winner, "env": res.winner_env,
            "wall_s": None if res.wall_s == float("inf")
            else round(res.wall_s, 3),
            "base_wall_s": None if res.base_wall_s == float("inf")
            else round(res.base_wall_s, 3),
            "gain_pct": round(res.gain_pct, 2),
            "rejected": res.rejected,
            "recorded_crc": (res.recorded or {}).get("crc"),
            "shape": perfdb.shape_sig(res.shape),
            "probes": measure.probes,
            "failed_probes": len(bad),
        }
        summary["env"].update(res.winner_env)

    out.write(json.dumps(summary) + "\n")
    if failed:
        log(f"tune: {failed} probe(s) failed — see the summary's probes")
        return 1
    return 0
