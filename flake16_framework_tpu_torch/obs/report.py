"""The ``report`` CLI verb: render one telemetry run's events.jsonl +
manifest.json into a human summary (or ``--json`` for CI). A copy of the
JAX package's ``obs/report.py``: either package's report reads either
package's run directory, and ``summarize`` gives the same document.

    python -m flake16_framework_tpu_torch report [RUN_DIR] [--json]
        [--attrib] [--flight] [--top N] [--root DIR]

With no RUN_DIR the latest run under the telemetry root is used (the root
is ``F16_TELEMETRY`` when it names a directory, else
``_scratch/telemetry`` — obs.core.default_root).

The compile/execute split keeps the JAX package's arithmetic and field
names: a span's first (name, key) occurrence is ``cold``. Per span name
the estimated "compile" wall is ``cold_total - cold_n * warm_mean``
(clamped at 0; the whole cold total when no warm call exists to
calibrate against), and execute wall is the remainder of the total. The
port compiles no program per shape, so on its runs the cold excess is
first-call cost: the kernels' library load, the allocator's first
growth and, with telemetry on, the counting pass of each entry point's
first signature (``obs/costs.py``).

``--attrib`` joins each config's stage walls to the kernels' launch
counts, from the fit and explain spans' ``k1_launches``/``k2_launches``
fields, and to the ``cost`` events of either package: the port's come
from ``obs/costs.py``'s counting passes and the serving store's graph
captures (``obs/aot.py``), the JAX package's from XLA's cost analysis.
The grower's ``stage_flops`` on them split the fit stage into ``fit.bin``,
``fit.hist_build``, ``fit.split_scan`` and ``fit.partition``.
"""

import json
import os
import sys

from flake16_framework_tpu_torch.obs import core, schema


def find_run_dir(path=None, root=None):
    """Resolve a run directory: an explicit run dir (has events.jsonl), an
    explicit root (newest run-* child), or the default root."""
    if path is not None:
        if os.path.isfile(os.path.join(path, schema.EVENTS_FILE)):
            return path
        root = path
    root = root or core.default_root()
    runs = sorted(
        (d for d in (os.path.join(root, n) for n in
                     (os.listdir(root) if os.path.isdir(root) else ()))
         if os.path.isfile(os.path.join(d, schema.EVENTS_FILE))),
        key=os.path.getmtime,
    )
    if not runs:
        raise SystemExit(
            f"no telemetry runs under {root!r} — run a verb with "
            "F16_TELEMETRY=1 first")
    return runs[-1]


def load_run(run_dir):
    """(manifest dict or {}, events list) — malformed lines are skipped
    (a crashed writer's torn final line must not kill the report)."""
    manifest = {}
    try:
        with open(os.path.join(run_dir, schema.MANIFEST_FILE)) as fd:
            manifest = json.load(fd)
    except (OSError, ValueError):
        pass
    events = []
    with open(os.path.join(run_dir, schema.EVENTS_FILE)) as fd:
        for line in fd:
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if isinstance(ev, dict):
                events.append(ev)
    return manifest, events


def summarize(manifest, events):
    """The report object (schema.REPORT_FIELDS) from one run's documents."""
    spans = {}
    counters = {}
    gauges = {}
    heartbeats = {"n": 0, "last_ts": None}
    faults = {"n": 0, "by_class": {}, "by_action": {}, "quarantined": []}
    lifecycle = {"journal": {}, "drain": {}, "restarts": 0}
    ts_all = [e["ts"] for e in events if isinstance(e.get("ts"), (int, float))]
    for ev in events:
        kind = ev.get("kind")
        if kind == "span" and isinstance(ev.get("wall_s"), (int, float)):
            st = spans.setdefault(ev.get("name", "?"), {
                "n": 0, "cold_n": 0, "cold_s": 0.0, "warm_s": 0.0})
            st["n"] += 1
            if ev.get("cold"):
                st["cold_n"] += 1
                st["cold_s"] += ev["wall_s"]
            else:
                st["warm_s"] += ev["wall_s"]
        elif kind == "counter":
            counters[ev.get("name", "?")] = ev.get("total", 0)
        elif kind == "gauge" and isinstance(ev.get("value"), (int, float)):
            st = gauges.setdefault(ev.get("name", "?"),
                                   {"peak": ev["value"]})
            st["peak"] = max(st["peak"], ev["value"])
            st["last"] = ev["value"]
        elif kind == "heartbeat":
            heartbeats["n"] += 1
            heartbeats["last_ts"] = ev.get("ts")
        elif kind == "fault":
            faults["n"] += 1
            fc = ev.get("fault_class", "?")
            act = ev.get("action", "?")
            faults["by_class"][fc] = faults["by_class"].get(fc, 0) + 1
            faults["by_action"][act] = faults["by_action"].get(act, 0) + 1
            if act == "quarantine":
                faults["quarantined"].append(ev.get("config", "?"))
        elif kind == "journal":
            act = ev.get("action", "?")
            lifecycle["journal"][act] = lifecycle["journal"].get(act, 0) + 1
        elif kind == "drain":
            ph = ev.get("phase", "?")
            lifecycle["drain"][ph] = lifecycle["drain"].get(ph, 0) + 1
        elif kind == "restart":
            lifecycle["restarts"] += 1

    started = manifest.get("started_ts")
    t0 = started if isinstance(started, (int, float)) else (
        min(ts_all) if ts_all else 0.0)
    wall_s = round(max(ts_all) - t0, 3) if ts_all else 0.0

    for st in spans.values():
        warm_n = st["n"] - st["cold_n"]
        warm_mean = st["warm_s"] / warm_n if warm_n else None
        if warm_mean is not None:
            compile_est = max(0.0, st["cold_s"] - st["cold_n"] * warm_mean)
        else:
            compile_est = st["cold_s"]  # no warm call to calibrate against
        total = st["cold_s"] + st["warm_s"]
        st.update(
            total_s=round(total, 3), cold_s=round(st["cold_s"], 3),
            warm_s=round(st["warm_s"], 3),
            warm_mean_s=round(warm_mean, 4) if warm_mean is not None
            else None,
            compile_est_s=round(compile_est, 3),
            execute_s=round(total - compile_est, 3),
        )

    throughput = {
        name: round(total / wall_s, 3)
        for name, total in counters.items()
        if wall_s > 0 and isinstance(total, (int, float))
    }
    return {
        "schema": schema.REPORT_SCHEMA,
        "run": manifest.get("run", "?"),
        "wall_s": wall_s,
        "manifest": manifest,
        "spans": spans,
        "counters": counters,
        "throughput_per_s": throughput,
        "gauges": gauges,
        "faults": faults,
        "heartbeats": heartbeats,
        "lifecycle": lifecycle,
        "n_events": len(events),
    }


# Span fields that count kernel launches -> the kernel they count.
_LAUNCH_FIELDS = (("k1_launches", "hist_cumsum"),
                  ("k2_launches", "treeshap_unit"))


def summarize_attrib(manifest, events):
    """The ``--attrib`` view: per-config stage walls joined to kernel
    launches (and, on a JAX package run, kernel costs). Span events carry
    ``stage`` (fit | predict | fused | plan | shap) and either ``config``
    or (batch spans) ``configs``; batch walls are split evenly across the
    batch's members — the engines' amortized-clock convention. Sub-stage
    fields refine the split: ``prep_s`` (and shap's ``resample_s``) peel
    the prep+resample work out of the fit wall into a ``resample`` stage,
    and shap's ``fit_s``/``explain_s`` separate growth from the explain
    itself.

    ``kernel_launches`` sums the spans' ``k1_launches`` (``hist_cumsum``,
    K1) and ``k2_launches`` (``treeshap_unit``, K2) per config, split over
    a batch span's members like its wall, with the run's totals under
    ``kernel_launch_totals``. ``cost`` events (either package's)
    aggregate by their ``span`` name into ``kernel_costs``; a grower cost
    event's ``stage_flops`` splits each fit wall into grower sub-stages,
    weighted by flops."""
    configs = {}
    stages = {}
    kernels = {}
    launches = {}
    stage_profile = {}  # grower sub-stage -> analytic flops (cost events)

    def charge(config, stage, wall):
        if wall <= 0:
            return
        st = configs.setdefault(config, {})
        st[stage] = st.get(stage, 0.0) + wall
        stages[stage] = stages.get(stage, 0.0) + wall

    for ev in events:
        kind = ev.get("kind")
        if kind == "span" and isinstance(ev.get("wall_s"), (int, float)):
            stage = ev.get("stage")
            if stage is None:
                continue  # pre-attribution spans (scores.run_grid, ...)
            targets = ev.get("configs") if isinstance(ev.get("configs"),
                                                      list) else None
            if targets is None:
                targets = [ev["config"]] if ev.get("config") else []
            if not targets:
                continue
            share = 1.0 / len(targets)
            wall = ev["wall_s"]
            # sub-stage refinements (fields ride on the span)
            split = []
            if stage == "fit":
                prep = ev.get("prep_s")
                if isinstance(prep, (int, float)):
                    split = [("resample", prep),
                             ("fit", max(0.0, wall - prep))]
            elif stage == "shap":
                if isinstance(ev.get("fit_s"), (int, float)):
                    prep = (ev.get("prep_s") or 0.0) + \
                        (ev.get("resample_s") or 0.0)
                    split = [("resample", prep), ("fit", ev["fit_s"]),
                             ("shap", ev.get("explain_s") or
                              max(0.0, wall - prep - ev["fit_s"]))]
            if not split:
                split = [(stage, wall)]
            for config in targets:
                for sname, swall in split:
                    charge(config, sname, swall * share)
                for field, kname in _LAUNCH_FIELDS:
                    n = ev.get(field)
                    if isinstance(n, int) and n > 0:
                        ln = launches.setdefault(config, {})
                        ln[kname] = ln.get(kname, 0.0) + n * share
        elif kind == "cost":
            k = kernels.setdefault(ev.get("span", "?"), {
                "n": 0, "flops": 0.0, "bytes": 0.0, "compile_s": 0.0,
                "lower_s": 0.0, "cache_hits": 0, "cache_misses": 0})
            k["n"] += 1
            for field in ("flops", "bytes", "compile_s", "lower_s"):
                if isinstance(ev.get(field), (int, float)):
                    k[field] += ev[field]
            for field in ("cache_hits", "cache_misses"):
                if isinstance(ev.get(field), int):
                    k[field] += ev[field]
            sf = ev.get("stage_flops")
            if isinstance(sf, dict):
                for sname, v in sf.items():
                    if isinstance(v, (int, float)) and v > 0:
                        stage_profile[sname] = \
                            stage_profile.get(sname, 0.0) + float(v)

    # Grower sub-stage refinement (see docstring): divide each fit wall
    # by the flop profile AFTER the scan — the profile needs every cost
    # event, and span order is not guaranteed relative to them.
    prof_total = sum(stage_profile.values())
    if prof_total > 0:
        def split_fit(st):
            wall = st.pop("fit", None)
            if wall:
                for sname, v in stage_profile.items():
                    st[f"fit.{sname}"] = (st.get(f"fit.{sname}", 0.0)
                                          + wall * v / prof_total)
        for st in configs.values():
            split_fit(st)
        split_fit(stages)

    for st in configs.values():
        st["total_s"] = round(sum(st.values()), 4)
        for name in list(st):
            st[name] = round(st[name], 4)
    # Deterministic ranking: equal walls tie-break by config code, then
    # stage name — dict-iteration order must never decide the table.
    ranked = sorted(configs, key=lambda c: (-configs[c]["total_s"], c))
    totals = {}
    for ln in launches.values():
        for kname, n in ln.items():
            totals[kname] = totals.get(kname, 0.0) + n
    return {
        "schema": schema.REPORT_SCHEMA + "+attrib",
        "run": manifest.get("run", "?"),
        "configs": {c: configs[c] for c in ranked},
        "stages": {s: round(w, 4) for s, w in
                   sorted(stages.items(), key=lambda kv: (-kv[1], kv[0]))},
        "kernel_costs": kernels,
        "kernel_launches": {c: {k: round(n, 3) for k, n in
                                sorted(launches[c].items())}
                            for c in ranked if c in launches},
        "kernel_launch_totals": {k: round(n, 3)
                                 for k, n in sorted(totals.items())},
    }


def render_attrib(attrib, top=15):
    """Human-readable ``--attrib`` view of a summarize_attrib() object."""
    out = [f"run {attrib['run']} — per-config stage attribution"]
    if attrib["stages"]:
        out.append("stage totals: " + "  ".join(
            f"{s}={w:.2f}s" for s, w in attrib["stages"].items()))
    out.append("")
    stage_names = list(attrib["stages"]) or ["fit"]
    configs = attrib["configs"]
    launches = attrib.get("kernel_launches") or {}
    kernel_names = list(attrib.get("kernel_launch_totals") or {})
    if configs:
        hdr = f"{'config':<52}{'total_s':>9}" + "".join(
            f"{s:>10}" for s in stage_names) + "".join(
            f"{k:>15}" for k in kernel_names)
        out += [hdr, "-" * len(hdr)]
        for c in list(configs)[:top]:
            st = configs[c]
            ln = launches.get(c, {})
            out.append(f"{c[:52]:<52}{st['total_s']:>9.3f}" + "".join(
                f"{st.get(s, 0.0):>10.3f}" for s in stage_names) + "".join(
                f"{ln.get(k, 0):>15g}" for k in kernel_names))
        if len(configs) > top:
            out.append(f"... {len(configs) - top} more configs")
        out.append("")
    if kernel_names:
        out.append("kernel launches (hist_cumsum = K1, treeshap_unit = K2) "
                   "from the fit and explain spans' k1_launches/k2_launches"
                   + ("" if attrib["kernel_costs"] else "; no cost events")
                   + ": " + "  ".join(
                       f"{k}={n:g}" for k, n in
                       attrib["kernel_launch_totals"].items()))
        out.append("")
    kernels = attrib["kernel_costs"]
    if kernels:
        hdr = (f"{'kernel':<26}{'compiles':>9}{'gflops':>10}{'gbytes':>10}"
               f"{'compile_s':>11}{'cache h/m':>11}")
        out += [hdr, "-" * len(hdr)]
        for name in sorted(kernels, key=lambda k: (-kernels[k]["flops"],
                                                   k)):
            k = kernels[name]
            out.append(
                f"{name:<26}{k['n']:>9}{k['flops'] / 1e9:>10.3f}"
                f"{k['bytes'] / 1e9:>10.3f}{k['compile_s']:>11.3f}"
                f"{k['cache_hits']:>6}/{k['cache_misses']:<4}")
    if not configs and not kernels:
        out.append("no attribution data — needs a run with stage-tagged "
                   "spans (scores/shap under F16_TELEMETRY=1)")
    return "\n".join(out)


def render(report):
    """Human-readable summary of a summarize() object."""
    m = report["manifest"]
    out = []
    ident = [f"run {report['run']}"]
    for field in ("backend", "device_kind", "device_count", "torch_version",
                  "cuda_version", "jax_version", "python"):
        if m.get(field) is not None:
            ident.append(f"{field}={m[field]}")
    if m.get("mesh_shape"):
        ident.append("mesh=" + "x".join(
            f"{k}:{v}" for k, v in m["mesh_shape"].items()))
    if m.get("git_sha"):
        ident.append(f"git={str(m['git_sha'])[:10]}")
    out.append("  ".join(ident))
    out.append(f"wall {report['wall_s']:.1f}s over {report['n_events']} "
               "events")
    out.append("")

    if report["spans"]:
        hdr = (f"{'span':<28}{'n':>5}{'cold':>6}{'compile_s':>11}"
               f"{'execute_s':>11}{'warm_mean_s':>13}")
        out += [hdr, "-" * len(hdr)]
        for name in sorted(report["spans"]):
            st = report["spans"][name]
            wm = st["warm_mean_s"]
            out.append(
                f"{name:<28}{st['n']:>5}{st['cold_n']:>6}"
                f"{st['compile_est_s']:>11.3f}{st['execute_s']:>11.3f}"
                f"{wm:>13.4f}" if wm is not None else
                f"{name:<28}{st['n']:>5}{st['cold_n']:>6}"
                f"{st['compile_est_s']:>11.3f}{st['execute_s']:>11.3f}"
                f"{'-':>13}")
        out.append("")

    if report["counters"]:
        hdr = f"{'counter':<28}{'total':>10}{'per_s':>10}"
        out += [hdr, "-" * len(hdr)]
        for name in sorted(report["counters"]):
            per_s = report["throughput_per_s"].get(name)
            out.append(
                f"{name:<28}{report['counters'][name]:>10}"
                + (f"{per_s:>10.3f}" if per_s is not None else f"{'-':>10}"))
        out.append("")

    if report["gauges"]:
        hdr = f"{'gauge':<28}{'peak':>12}{'last':>12}"
        out += [hdr, "-" * len(hdr)]
        for name in sorted(report["gauges"]):
            g = report["gauges"][name]
            out.append(f"{name:<28}{g['peak']:>12.1f}"
                       f"{g.get('last', g['peak']):>12.1f}")
        out.append("")

    faults = report.get("faults") or {}
    if faults.get("n"):
        by_class = ", ".join(f"{k}={v}" for k, v in
                             sorted(faults["by_class"].items()))
        by_action = ", ".join(f"{k}={v}" for k, v in
                              sorted(faults["by_action"].items()))
        out.append(f"faults: {faults['n']} ({by_class})")
        out.append(f"  actions: {by_action}")
        if faults.get("quarantined"):
            out.append("  quarantined: "
                       + ", ".join(str(c) for c in faults["quarantined"]))
        out.append("")

    life = report.get("lifecycle") or {}
    if life.get("restarts") or life.get("journal") or life.get("drain"):
        parts = []
        if life.get("journal"):
            parts.append("journal " + ", ".join(
                f"{k}={v}" for k, v in sorted(life["journal"].items())))
        if life.get("drain"):
            parts.append("drain " + ", ".join(
                f"{k}={v}" for k, v in sorted(life["drain"].items())))
        if life.get("restarts"):
            parts.append(f"restarts={life['restarts']}")
        out.append("lifecycle: " + "; ".join(parts))
        out.append("")

    hb = report["heartbeats"]
    if hb["n"]:
        out.append(f"heartbeats: {hb['n']} (last at ts {hb['last_ts']})")
    return "\n".join(out)


def report_main(args, out=None):
    """CLI entry for the ``report`` verb (``__main__.py``)."""
    out = out or sys.stdout
    as_json = False
    attrib = False
    flight = False
    top = 15
    root = None
    path = None
    it = iter(args)
    for a in it:
        if a == "--json":
            as_json = True
        elif a == "--attrib":
            attrib = True
        elif a == "--flight":
            flight = True
        elif a == "--top":
            raw = next(it, None)
            if raw is None:
                raise ValueError("--top needs a count argument")
            top = int(raw)
        elif a == "--root":
            root = next(it, None)
            if root is None:
                raise ValueError("--root needs a directory argument")
        elif a.startswith("--"):
            raise ValueError(f"Unrecognized report option {a!r}")
        elif path is None:
            path = a
        else:
            raise ValueError(f"Unrecognized report argument {a!r}")
    if flight:
        # ``report --flight [PATH]``: PATH may be the ring file itself
        # (the supervisor's explicit-path form), a directory of
        # per-worker rings (the fleet form — merged by timestamp), or a
        # run dir holding flight.bin; default = the latest run's ring.
        from flake16_framework_tpu_torch.obs import flight as _flight

        rings = [n for n in os.listdir(path)
                 if n.endswith(".bin")] \
            if path is not None and os.path.isdir(path) else []
        if path is not None and os.path.isfile(path):
            ring = path
        elif len(rings) > 1 or any(
                os.path.splitext(n)[0].rpartition(".")[2].startswith("w")
                and n != "flight.bin" for n in rings):
            # Multiple rings, or per-worker ``.w<i>`` suffixed rings: a
            # fleet workdir — merge. A run dir's single flight.bin
            # keeps the classic single-ring path below.
            records, meta = _flight.dump_dir(path, out=out,
                                             flush_manifest=False)
            if as_json:
                out.write(json.dumps(
                    {"meta": meta,
                     "gauges": _flight.last_gauges(records)},
                    indent=1, default=str) + "\n")
            return {"meta": meta, "records": records}
        else:
            ring = os.path.join(find_run_dir(path, root), "flight.bin")
        if not os.path.isfile(ring):
            raise SystemExit(
                f"no flight record at {ring!r} — arm one with "
                "F16_FLIGHT=1")
        records, meta = _flight.dump(ring, out=out, flush_manifest=False)
        if as_json:
            out.write(json.dumps(
                {"meta": meta, "gauges": _flight.last_gauges(records)},
                indent=1, default=str) + "\n")
        return {"meta": meta, "records": records}
    run_dir = find_run_dir(path, root)
    manifest, events = load_run(run_dir)
    if attrib:
        report = summarize_attrib(manifest, events)
        if as_json:
            out.write(json.dumps(report, indent=1, default=str) + "\n")
        else:
            out.write(f"[{run_dir}]\n" + render_attrib(report, top=top)
                      + "\n")
        return report
    report = summarize(manifest, events)
    if as_json:
        out.write(json.dumps(report, indent=1, default=str) + "\n")
    else:
        out.write(f"[{run_dir}]\n" + render(report) + "\n")
    return report
