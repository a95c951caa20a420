"""Everything a run needs, found by name: the cell's entry in
``BENCHMARK.json``, its own file ``workloads/<cell>.json`` (the traffic
driver and its parameters), ``configs/<config>.json``, the driver
``traffic/<driver>.py`` and each metric ``metrics/<metric>.py``. Nothing
here knows a cell, a configuration or a metric by name."""

import importlib.util
import json
import os
from typing import NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class SpecError(ValueError):
    """The files do not describe the cell asked for."""


def _json(path):
    try:
        with open(path) as fd:
            return json.load(fd)
    except FileNotFoundError:
        raise SpecError(f"missing {os.path.relpath(path, ROOT)}") from None


def load_module(kind, name, bench_dir=BENCH_DIR):
    """The module ``<bench_dir>/<kind>/<name>.py`` (a metric's name may
    hold dots, so it is loaded from its path)."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.exists(path):
        raise SpecError(f"missing {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(NamedTuple):
    name: str
    entry: dict          # the BENCHMARK.json workload entry
    workload: dict       # workloads/<name>.json
    config: dict         # configs/<config>.json
    end_to_end: list     # the end-to-end metric entries the cell reports
    per_layer: list      # the per-layer metric entries the cell reports
    bench_dir: str       # where its driver and metrics are


def _applies(metric, cell_name, reported=None):
    """Whether ``metric`` is reported in the cell: its ``workloads`` list
    names it, or, without one, the cell reports what it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_cell(name, root=ROOT):
    """The cell ``name`` as the files under ``root`` (a checkout) give
    it."""
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(entries)})")
    entry = entries[name]
    workload = _json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if workload.get(key) != entry[key]:
            raise SpecError(f"workloads/{name}.json: {key} "
                            f"{workload.get(key)!r} but BENCHMARK.json says "
                            f"{entry[key]!r}")
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[entry["config"]]["file"]))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, entry, workload, config, e2e, per_layer, bench_dir)
