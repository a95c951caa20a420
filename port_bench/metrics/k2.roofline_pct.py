"""K2's share of its roofline over the traced stretch: the least time of
each SHAP dispatch's unit launch (the frozen work model,
``harness/work.py``, on the served model's single-bucket rows, which the
frozen ``graph_inputs`` makes from the registered forest, and the
dispatch's padded rows after the model's transform) over the device time
of the SHAP graph replays (the launches whose kernels include the unit,
``treeshap_unit``), both summed over the stretch."""

import numpy as np
import torch

from port_bench.harness import timeline, work
from port_bench.reference.preprocess import transform
from port_bench.reference.treeshap import graph_inputs

RANGE = "port_bench.dispatch"
UNIT = "treeshap_unit"


def _shap_batch(args, kwargs):
    _, model, kind, x = args
    if kind != "shap":
        return None
    return {"shap": (model.model_id, np.array(x, np.float32, copy=True))}


HOOKS = [{"target":
          "flake16_framework_tpu_torch.serve.store:ExecutableStore.call",
          "range": RANGE, "record": _shap_batch}]


def read(ctx):
    evs = timeline.device_events(ctx["tracer"].events, ctx["t0"], ctx["t1"])
    replays = [g for g in timeline.launches(evs).values()
               if any(UNIT in e.name for e in g)]
    device_s = sum(timeline.duration_ns(g) for g in replays) / 1e9
    batches = [c["shap"] for c in ctx["tracer"].calls.get(RANGE, [])
               if "shap" in c]
    if device_s <= 0 or not batches:
        return None
    registry = ctx["state"]["registry"]
    by_model = {}
    for model_id, x in batches:
        by_model.setdefault(model_id, []).append(x)
    bound_s = 0.0
    for model_id, xs in by_model.items():
        model = registry.get(model_id)
        dev = model.mu.device
        xt = [transform(torch.as_tensor(x, device=dev), model.mu,
                        model.wmat).contiguous() for x in xs]
        rows = graph_inputs(model.forest, len(model.cols))
        bound_s += sum(work.k2_seconds(rows, xt))
    return 100.0 * bound_s / device_s
