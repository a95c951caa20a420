"""Device ms a config of the predict walk over the folds' forests
(``trees.predict_batch``, the sweep's call of the walk and the tree mean),
wrapped in the benchmark's range where the sweep looks it up."""

from port_bench.harness import timeline

RANGE = "port_bench.predict"
HOOKS = [{"target": "flake16_framework_tpu_torch.ops.trees:predict_batch",
          "range": RANGE}]


def read(ctx):
    n = ctx["tracer"].units.get("configs")
    if not n:
        return None
    evs = timeline.under_range(ctx["tracer"].events, RANGE)
    return timeline.duration_ns(evs) / 1e6 / n if evs else None
