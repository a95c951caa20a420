"""The performance database's storage plane (a copy of the JAX
package's ``obs/perfdb.py``, in its file format).

An append-only JSONL database of performance observations — schema
``flake16-perfdb-v1`` (obs/schema.py) — keyed by the quadruple

    (backend, shape-signature, kernel/stage, knob-snapshot digest)

so the committed bench history, telemetry runs and audit memory
envelopes land in ONE queryable substrate that either package reads
and writes. Its producers:

- ``rows_from_bench`` — a bench result line (or a committed
  ``BENCH_rNN.json`` wrapper): headline value, per-stage walls,
  per-config walls, dispatch censuses, and the CPU baseline walls.
  Historical rounds predate the ``detail.knobs`` snapshot and are
  stamped ``knobs: null`` — self-describing absence, not a guess.
- ``rows_from_run`` — a telemetry run dir: per-stage span walls and,
  per kernel, the JAX package's ``cost`` aggregates or this package's
  launch counts (``kernel.hist_cumsum``, ``kernel.treeshap_unit``);
  the manifest's env fingerprint provides the knob snapshot.
- ``rows_from_audit`` — an ``audit --json`` document's memory
  envelopes (peak/arg/out MB per traced entry point).

Durability follows resilience/journal.py: every row carries a crc32
seal over its canonical JSON; ``load`` verifies per line and a torn or
corrupt TAIL is truncated on the next append (a crash mid-write loses
at most the row being written — never the history before it).

The read plane is ``lookup(backend, shape_sig)``: the best-known
(lowest primary wall) knob-carrying row for a key, which the planner
(plan batch padding), the plan executor (the hist grower's window
width) and the scoring service (warm buckets) consult with a safe
fall-through — no database, no row, or no usable knob means current
defaults, bit-identically. ``backend`` is the torch device type, ``cuda``
or ``cpu``.
"""

import contextlib
import fcntl
import hashlib
import json
import os
import threading
import time
import zlib

from flake16_framework_tpu_torch.obs import core, schema

DB_ENV = "F16_PERFDB"
DB_FILE = os.path.join("_scratch", "perfdb.jsonl")

# Serializes IN-PROCESS appenders: recover->dedup->append must be atomic
# or two appenders double-write the same identity. CROSS-process
# appenders (fleet workers, or either package, writing one db path) are
# serialized by an ``fcntl`` lock on ``<path>.lock`` — see
# ``_file_lock`` — so the
# recover->dedup->append window is atomic fleet-wide, not just
# process-wide. A crashed writer's torn tail is still healed by
# ``recover`` on the next append; the flock is released by the kernel
# when the holder dies, so a crash never wedges the db.
_append_lock = threading.Lock()


@contextlib.contextmanager
def _file_lock(path):
    """Exclusive ``fcntl.flock`` on ``path + ".lock"`` (a sidecar, so the
    db file itself can be atomically recovered/truncated under the lock
    without disturbing the lock inode). Blocks until acquired; released
    on exit and — because flocks die with their holder — on crash."""
    lock_path = path + ".lock"
    fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)

# Repo root (committed BENCH_rNN.json live beside the package dir).
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Env prefixes that constitute a knob snapshot — the same families the
# run manifest fingerprints (obs/core._env_fingerprint), minus the
# runtime noise that never tunes a kernel.
_KNOB_PREFIXES = ("F16_", "BENCH_")

# Metrics whose name alone declares a wall: the primary ranking key for
# ``lookup`` (lower is better) and the lanes the diff Perfetto export
# renders (obs/perf_diff.py).
WALL_METRICS = ("wall_s", "total_s", "fit_s", "predict_s", "shap_s",
                "scores_s", "warm_s", "compile_s")


def default_db(path=None):
    """Resolve the database path: explicit arg > ``F16_PERFDB`` env >
    ``_scratch/perfdb.jsonl`` under the cwd. ``F16_PERFDB=0`` disables
    the default consult paths (lookup helpers return nothing)."""
    if path is not None:
        return path
    env = os.environ.get(DB_ENV, "")
    if env == "0":
        return None
    return env or DB_FILE


def knob_snapshot(env=None):
    """The full F16_*/BENCH_* knob environment as a sorted dict of
    strings — what ``detail.knobs`` carries in every bench record."""
    env = os.environ if env is None else env
    return {k: str(env[k]) for k in sorted(env)
            if k.startswith(_KNOB_PREFIXES)}


def knob_digest(knobs):
    """The key component for a knob snapshot: ``"null"`` for absent
    knobs (historical rounds), else a short stable digest."""
    if not knobs:
        return "null"
    blob = json.dumps(knobs, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def shape_sig(shape):
    """The shape-signature string for a planner shape tuple
    (n, n_feat, n_trees, n_folds, cap) — the ``shape`` key component the
    planner consult uses."""
    n, n_feat, n_trees, n_folds, cap = (int(x) for x in tuple(shape)[:5])
    return f"n{n}.f{n_feat}.t{n_trees}.k{n_folds}.c{cap}"


def _row_crc(row):
    body = {k: v for k, v in row.items() if k != "crc"}
    blob = json.dumps(body, sort_keys=True, default=str).encode()
    return f"{zlib.crc32(blob) & 0xFFFFFFFF:08x}"


def make_row(backend, shape, kernel, metrics, *, knobs=None, src="api",
             round_tag=None, baseline=None, tuned=False, ts=None):
    """One sealed perfdb row. ``metrics`` keeps only finite numerics;
    empty metrics is a caller bug (a row that measures nothing)."""
    clean = {}
    for name, v in (metrics or {}).items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        if v != v or v in (float("inf"), float("-inf")):
            continue
        clean[name] = v
    if not clean:
        raise ValueError(f"perfdb row {backend}/{shape}/{kernel} carries "
                         "no numeric metrics")
    row = {
        "schema": schema.PERFDB_SCHEMA,
        "backend": str(backend or "unknown"),
        "shape": str(shape),
        "kernel": str(kernel),
        "ksig": knob_digest(knobs),
        "knobs": dict(knobs) if knobs else None,
        "metrics": clean,
        "src": str(src),
        "round": round_tag,
        "baseline": baseline,
        "tuned": bool(tuned),
        "ts": time.time() if ts is None else ts,
    }
    row["crc"] = _row_crc(row)
    return row


def row_identity(row):
    """The dedupe identity: one observation per key quadruple per
    source. Re-ingesting the same document is a no-op (idempotent
    backfill), while a NEW round/run for the same key appends."""
    return (row.get("backend"), row.get("shape"), row.get("kernel"),
            row.get("ksig"), row.get("src"))


def _parse_line(line):
    line = line.strip()
    if not line:
        return None
    try:
        row = json.loads(line)
    except ValueError:
        return None
    if not isinstance(row, dict) or row.get("crc") != _row_crc(row):
        return None
    if schema.validate_perfdb_row(row):
        return None
    return row


def load(path=None):
    """All valid rows in the database (CRC-verified per line; torn or
    corrupt lines are skipped — a crashed writer's tail must not kill
    the read plane). Missing database = empty history."""
    path = default_db(path)
    if path is None or not os.path.isfile(path):
        return []
    rows = []
    with open(path, "rb") as fd:
        for raw in fd:
            row = _parse_line(raw.decode("utf-8", "replace"))
            if row is not None:
                rows.append(row)
    return rows


def recover(path):
    """Truncate a torn/corrupt TAIL in place (resilience/journal.py's
    crash contract): every complete CRC-valid prefix row survives, the
    partial write of a dying process is cut. Returns (n_rows, n_cut)."""
    if not os.path.isfile(path):
        return 0, 0
    good_end = 0
    n_rows = 0
    with open(path, "rb") as fd:
        data = fd.read()
    offset = 0
    for raw in data.splitlines(keepends=True):
        end = offset + len(raw)
        if raw.endswith(b"\n") and \
                _parse_line(raw.decode("utf-8", "replace")) is not None:
            good_end = end
            n_rows += 1
        offset = end
    n_cut = len(data) - good_end
    if n_cut:
        with open(path, "r+b") as fd:
            fd.truncate(good_end)
        core.event("perf", action="truncate", offset=good_end,
                   cut_bytes=n_cut, path=path)
    return n_rows, n_cut


def append(rows, path=None):
    """Append rows not already present (by ``row_identity``), after
    recovering any torn tail. Returns the number written.

    Safe under concurrent appenders — same-process writers serialize on
    ``_append_lock``, other processes on the ``fcntl`` sidecar lock — so
    fleet workers ingesting into a shared db path cannot double-write an
    identity or interleave a recover with another's append."""
    path = default_db(path)
    if path is None:
        return 0
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with _append_lock, _file_lock(path):
        recover(path)
        seen = {row_identity(r) for r in load(path)}
        n = 0
        for row in rows:
            if row_identity(row) in seen:
                continue
            seen.add(row_identity(row))
            core.append_jsonl(path, row)
            n += 1
    if n:
        core.event("perf", action="append", n=n, path=path)
    return n


# -- producers: bench records, telemetry runs, audit documents ----------


def _baseline_tag(detail):
    """A short comparability tag from the bench's SHAP-baseline prose:
    r02's numpy oracle is ~15x slower than the C baseline r03+ compare
    against, so speedup series must not mix them."""
    text = detail.get("shap_baseline") or ""
    if "native C" in text or "cext" in text:
        return "cext"
    if "numpy" in text:
        return "numpy"
    return text or None


def rows_from_bench(doc, src, round_tag=None):
    """Perfdb rows from one bench result document — either a raw bench.py
    output line ({"metric", "value", ..., "detail"}) or a committed
    BENCH_rNN.json wrapper ({"n", "parsed": {...}}). Handles every
    committed vintage: r01's minimal probe, r02–r05's flat per_config_s,
    r06's serve round, r07+'s per-stage dicts."""
    if "parsed" in doc:
        if round_tag is None and isinstance(doc.get("n"), int):
            round_tag = f"r{doc['n']:02d}"
        doc = doc.get("parsed") or {}
    detail = doc.get("detail") or {}
    backend = detail.get("backend") or "unknown"
    knobs = detail.get("knobs")
    if not isinstance(knobs, dict) or not knobs:
        knobs = None  # historical rounds: self-describing absence
    baseline = _baseline_tag(detail)
    metric = doc.get("metric") or ""

    def row(shape, kernel, metrics, **kw):
        try:
            return make_row(backend, shape, kernel, metrics, knobs=knobs,
                            src=src, round_tag=round_tag, **kw)
        except ValueError:
            return None

    rows = []
    if metric.startswith("fleet") or "fleet_rps" in detail:
        # A fleet bench round ("fleet_sustained_rps") lands as ONE
        # shape="fleet" row whose metrics keep their fleet_* names, so
        # perf diff and the trajectory sentinel cover the fleet
        # trajectory alongside the serve one.
        metrics = {k: v for k, v in detail.items()
                   if isinstance(v, (int, float))
                   and not isinstance(v, bool)
                   and (k.startswith("fleet_")
                        or k in ("single_rps", "single_p99_ms",
                                 "n_cores"))}
        rows.append(row("fleet", "fleet", metrics, baseline=baseline))
        return [r for r in rows if r is not None]
    if metric.startswith("serve") or "serve_rps" in detail:
        metrics = {k.replace("serve_", "").replace("slo_", ""): v
                   for k, v in detail.items()
                   if isinstance(v, (int, float))
                   and not isinstance(v, bool)
                   and k not in ("n_tests", "n_trees", "rows", "clients",
                                 "requests")}
        rows.append(row("serve", "serve", metrics, baseline=baseline))
        return [r for r in rows if r is not None]

    n = detail.get("n_tests")
    t = detail.get("n_trees")
    shape = "probe" + (f".n{n}" if n else "") + (f".t{t}" if t else "")
    if isinstance(doc.get("value"), (int, float)):
        rows.append(row(shape, "headline", {"value": doc["value"]},
                        baseline=baseline))
    stage_walls = {
        "fit": detail.get("t_ours_fit_s"),
        "predict": detail.get("t_ours_predict_s"),
        "scores": detail.get("t_ours_scores_s"),
        "shap": detail.get("t_ours_shap_s"),
        "shap_grid": detail.get("shap_grid_wall_s"),
        "shap_interact": detail.get("shap_interact_s"),
        "total": detail.get("t_ours_s"),
    }
    for kernel, wall in stage_walls.items():
        metrics = {"wall_s": wall}
        if kernel == "fit" and detail.get("fit_gflops") is not None:
            metrics["gflops"] = detail["fit_gflops"]
        if wall is not None:
            rows.append(row(shape, kernel, metrics))
    census = {k: detail[k] for k in ("grid_dispatch_count",
                                     "shap_dispatch_count")
              if isinstance(detail.get(k), (int, float))}
    if census:
        rows.append(row(shape, "dispatch", census))
    cpu = {"scores_s": detail.get("t_cpu_scores_s"),
           "shap_s": detail.get("t_cpu_shap_s"),
           "sklearn_s": detail.get("t_sklearn_s")}
    cpu = {k: v for k, v in cpu.items() if v is not None}
    if cpu:
        rows.append(row(shape, "baseline_cpu", cpu, baseline=baseline))

    per_config = detail.get("per_config_s")
    per_shap = detail.get("per_config_shap_s") or {}
    merged = {}
    if isinstance(per_config, dict):
        for code, v in per_config.items():
            if isinstance(v, dict):
                # r07+: {"fit": ..., "predict": ..., "total": ...}
                merged[code] = {f"{k}_s": w for k, w in v.items()
                                if isinstance(w, (int, float))}
            elif isinstance(v, (int, float)):
                merged[code] = {"total_s": v}  # r02–r05 flat form
    if isinstance(per_shap, dict):
        for code, v in per_shap.items():
            if isinstance(v, dict):
                merged.setdefault(code, {}).update(
                    {f"{k}_s": w for k, w in v.items()
                     if isinstance(w, (int, float))})
            elif isinstance(v, (int, float)):
                merged.setdefault(code, {})["shap_s"] = v
    for code, metrics in merged.items():
        rows.append(row(shape, f"config.{code}", metrics))
    return [r for r in rows if r is not None]


def rows_from_run(run_dir):
    """Perfdb rows from one telemetry run dir: per-stage span walls (the
    ``report --attrib`` join) and per-kernel rows, knob-snapshotted from
    the manifest's env fingerprint. Each entry point's ``cost`` aggregate
    gives a ``kernel.<span>`` row (flops, bytes, compile_s, n), on a run
    of either package: the port's cost events come from its counting
    passes and graph captures (``obs/costs.py``, ``obs/aot.py``). A run of
    this package also gives each CUDA kernel's launches on the run
    (``kernel.hist_cumsum``/``kernel.treeshap_unit``, ``n``)."""
    from flake16_framework_tpu_torch.obs import report

    manifest, events = report.load_run(run_dir)
    backend = manifest.get("backend") or "unknown"
    knobs = knob_snapshot(manifest.get("env") or {}) or None
    src = f"run:{manifest.get('run') or os.path.basename(run_dir)}"

    attrib = report.summarize_attrib(manifest, events)
    rows = []

    def row(kernel, metrics):
        try:
            return make_row(backend, "run", kernel, metrics, knobs=knobs,
                            src=src)
        except ValueError:
            return None

    for name, wall in attrib.get("stages", {}).items():
        rows.append(row(f"stage.{name}", {"wall_s": wall}))
    for name, k in attrib.get("kernel_costs", {}).items():
        rows.append(row(f"kernel.{name}", {
            "flops": k.get("flops"), "bytes": k.get("bytes"),
            "compile_s": k.get("compile_s"), "n": k.get("n")}))
    for name, n in attrib.get("kernel_launch_totals", {}).items():
        rows.append(row(f"kernel.{name}", {"n": n}))
    return [r for r in rows if r is not None]


def rows_from_audit(doc, src="audit"):
    """Perfdb rows from an ``audit --json`` document of either package:
    the per-entry memory envelopes become ``audit.<entry>`` rows (peak,
    arg and out MB) under the document's ``backend`` (the port's audit
    names ``cuda`` or ``cpu``; the JAX package's traces abstractly and
    names none, so ``abstract``). A port envelope's hist window ``width``
    rides along as a metric; the JAX package's envelopes carry none, and
    ``perf/tuner.py`` reads their width as 8."""
    rows = []
    for env in doc.get("envelopes") or ():
        if not isinstance(env, dict) or "entry" not in env:
            continue
        metrics = {
            "peak_mb": env.get("peak_mb"),
            "arg_mb": (env["arg_bytes"] / 1e6
                       if isinstance(env.get("arg_bytes"), (int, float))
                       else None),
            "out_mb": (env["out_bytes"] / 1e6
                       if isinstance(env.get("out_bytes"), (int, float))
                       else None),
        }
        if isinstance(env.get("width"), (int, float)):
            metrics["width"] = env["width"]
        try:
            rows.append(make_row(doc.get("backend") or "abstract", "audit",
                                 f"audit.{env['entry']}", metrics, src=src))
        except ValueError:
            continue
    return rows


def rows_from_path(path, round_tag=None):
    """Dispatch one ingestible path: a telemetry run dir, a bench result
    JSON (raw line or committed BENCH wrapper), or an audit document."""
    if os.path.isdir(path):
        return rows_from_run(path)
    with open(path) as fd:
        doc = json.load(fd)
    if isinstance(doc, dict) and doc.get("schema") == schema.AUDIT_SCHEMA:
        return rows_from_audit(doc, src=os.path.basename(path))
    if round_tag is None:
        m = os.path.basename(path)
        if m.startswith("BENCH_r") and m.endswith(".json"):
            round_tag = m[len("BENCH_"):-len(".json")]
    return rows_from_bench(doc, os.path.basename(path),
                           round_tag=round_tag)


def committed_rounds(repo_root=None):
    """{round_tag: path} of the committed BENCH_rNN.json trajectory."""
    root = repo_root or _REPO
    out = {}
    for name in sorted(os.listdir(root) if os.path.isdir(root) else ()):
        if name.startswith("BENCH_r") and name.endswith(".json"):
            out[name[len("BENCH_"):-len(".json")]] = \
                os.path.join(root, name)
    return out


def backfill(path=None, repo_root=None):
    """One-shot ingest of every committed BENCH_rNN.json: the rounds of
    history become queryable day one. Idempotent — rows already present
    (by identity) are skipped. Returns {round: n_new}."""
    out = {}
    rounds = committed_rounds(repo_root)
    for tag, p in rounds.items():
        out[tag] = append(rows_from_path(p, round_tag=tag), path=path)
    if any(out.values()):
        core.event("perf", action="backfill", n=sum(out.values()),
                   rounds=len(rounds))
    return out


# -- the read plane: lookup + consult helpers ---------------------------


def primary_wall(metrics):
    """The ranking wall of a row's metrics (first WALL_METRICS hit)."""
    for name in WALL_METRICS:
        v = metrics.get(name)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    return None


def lookup(backend, shape_sig_, kernel=None, path=None, rows=None):
    """The best-known knob-carrying observation for a key: among rows
    matching (backend, shape_sig) — and ``kernel`` when given — with a
    non-null knob snapshot, the one with the lowest primary wall
    (wall-less rows fall back to recency). Equal walls (and equal
    recency) tie-break by row key order — (kernel, ksig, src, backend)
    ascending — NOT file order, so consults pick the same winner from
    any row permutation. Returns the row, or None — the safe
    fall-through the planner/serve consults rely on: no database, no
    row, or no knobs means current defaults."""
    if rows is None:
        rows = load(path)
    best = None
    best_key = None
    for row in rows:
        if row.get("backend") not in (backend, "*"):
            continue
        if row.get("shape") != shape_sig_:
            continue
        if kernel is not None and row.get("kernel") != kernel:
            continue
        if not row.get("knobs"):
            continue
        wall = primary_wall(row.get("metrics") or {})
        order = (str(row.get("kernel")), str(row.get("ksig")),
                 str(row.get("src")), str(row.get("backend")))
        key = (0, wall, order) if wall is not None else \
            (1, -float(row.get("ts") or 0.0), order)
        if best_key is None or key < best_key:
            best, best_key = row, key
    return best


def record_tuned(backend, shape, kernel, knobs, metrics, path=None,
                 src="tuned"):
    """Write one best-known-knobs row — the autotuner's write API
    (ROADMAP.md §A 6), also used to seed lookup fixtures."""
    row = make_row(backend, shape, kernel, metrics, knobs=knobs, src=src,
                   tuned=True)
    append([row], path=path)
    return row


def model_kernel(model_name):
    """The per-model fit kernel key ("fit.extra_trees"): plan shapes
    collide across models (Flake16 RF and ET share (n, f, t, k, cap)),
    so tuned fit rows carry the model in the kernel component; plain
    "fit" remains the family-agnostic fallback key."""
    return "fit." + str(model_name).strip().lower().replace(" ", "_")


# Grower kwargs a tuned fit row may override at plan time, with the env
# pins that outrank the database (an operator's export must win over a
# recorded winner: the grower reads them itself, in
# ``trees.default_node_batch``) and the sanity bounds a recorded value
# must satisfy (a corrupt row must never change execution).
# ``node_batch`` is the hist grower's BFS window width
# (``trees.fit_folds_hist``): its upper
# bound is the widest window K1's histogram holds in shared memory at
# the grower's resolved bins (``trees.hist_bins``,
# ``kernels/hist.max_window``), so a width the JAX package's tuner
# recorded (up to 4096) or a corrupt one can never make K1 raise
# mid-sweep. The JAX package's ``refine_tile`` has no counterpart: the
# port's refinement has no tile loop. Parity-affecting knobs
# (``F16_HIST_BINS``) are deliberately not in the map, as in the JAX
# package: a tuned row never carries them into a plan; they take effect
# only when exported, so the plan path can never diverge from the
# per-config and journal-resume paths.
def _k1_window_max():
    from flake16_framework_tpu_torch.kernels.hist import max_window
    from flake16_framework_tpu_torch.ops.trees import hist_bins

    return max_window(hist_bins())


_TUNED_FIT_KNOBS = (
    ("node_batch", ("F16_HIST_NODE_BATCH_CPU", "F16_HIST_NODE_BATCH"),
     1, _k1_window_max),
)


def tuned_fit_row(backend, shape, model=None, path=None, rows=None):
    """The best TUNED fit row for (backend, shape[, model]), or None.
    Per-model rows (kernel ``model_kernel(model)``) outrank the
    family-agnostic "fit" key; non-tuned rows never qualify."""
    if rows is None:
        db = default_db(path)
        if db is None or not os.path.isfile(db):
            return None
        try:
            rows = load(db)
        except Exception:
            return None
    sig = shape if isinstance(shape, str) else shape_sig(shape)
    row = None
    if model is not None:
        row = lookup(backend, sig, kernel=model_kernel(model), rows=rows)
    if row is None:
        row = lookup(backend, sig, kernel="fit", rows=rows)
    if row is None or not row.get("tuned"):
        return None
    return row


def tuned_fit_overrides(backend, shape, model=None, path=None, rows=None,
                        env=None):
    """Sanitized grower kwargs ({"node_batch": int} or {}) from the best
    TUNED fit row for (backend, shape[, model]) — the plan-time consult
    ``SweepEngine.run_plan`` feeds into the hist grower. Every
    fall-through — no database, unreadable rows, no tuned row,
    env-pinned knob, unparsable or out-of-bounds value — yields {} and
    the grower keeps today's default width. The window width is
    results-neutral (``trees.fit_folds_hist``), so the plan path can
    never diverge from the per-config/journal-resume paths."""
    row = tuned_fit_row(backend, shape, model=model, path=path, rows=rows)
    if row is None:
        return {}
    env = os.environ if env is None else env
    knobs = row.get("knobs") or {}
    out = {}
    for kwarg, env_names, lo, hi in _TUNED_FIT_KNOBS:
        if any(name in env for name in env_names):
            continue
        for name in env_names:
            raw = knobs.get(name)
            if raw is None:
                continue
            try:
                v = int(raw)
            except (TypeError, ValueError):
                continue
            if lo <= v <= hi():
                out[kwarg] = v
                break
    return out


def plan_lookup(backend, path=None):
    """A ``perf_lookup`` callable for planner.plan_grid — shape tuple ->
    recorded knob dict — or None when the database is absent/disabled
    (the planner path then stays byte-for-byte what it is today). Rows
    load once per sweep, not once per plan."""
    db = default_db(path)
    if db is None or not os.path.isfile(db):
        return None
    rows = load(db)

    def _lookup(shape):
        row = lookup(backend, shape_sig(shape), kernel="fit", rows=rows)
        return dict(row["knobs"]) if row else {}

    return _lookup


def serve_buckets(backend=None, path=None):
    """Recorded serve warm buckets for the scoring service, or None to
    fall through to serve.service.DEFAULT_BUCKETS. Only a strictly valid
    recorded value (non-empty list of positive ints) is returned — a
    malformed row must never change serve behavior. ``backend`` defaults
    to the device type this process runs on (``_current_backend``)."""
    db = default_db(path)
    if db is None or not os.path.isfile(db):
        return None
    if backend is None:
        backend = _current_backend()
    row = lookup(backend, "serve", kernel="serve", path=db)
    if row is None:
        return None
    raw = (row.get("knobs") or {}).get("serve_buckets")
    if not isinstance(raw, (list, tuple)) or not raw:
        return None
    try:
        buckets = tuple(sorted(int(b) for b in raw))
    except (TypeError, ValueError):
        return None
    if any(b <= 0 for b in buckets):
        return None
    return buckets


def _current_backend():
    """``cuda`` when this process has a CUDA context, else ``cpu`` — the
    manifest's ``backend`` (obs/core.record_device_manifest). Never
    imports torch or initializes CUDA just to answer."""
    import sys

    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_initialized():
                return "cuda"
        except (AttributeError, RuntimeError):
            pass
    return "cpu"
