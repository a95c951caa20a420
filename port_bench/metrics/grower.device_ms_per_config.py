"""Device ms a config of everything the hist grower launches
(``trees.fit_folds_hist``: the random draws, K1, the split scan, the
routing), the call wrapped in the benchmark's range where the sweep looks
it up."""

from port_bench.harness import timeline

RANGE = "port_bench.grower"
HOOKS = [{"target": "flake16_framework_tpu_torch.ops.trees:fit_folds_hist",
          "range": RANGE}]


def read(ctx):
    n = ctx["tracer"].units.get("configs")
    if not n:
        return None
    evs = timeline.under_range(ctx["tracer"].events, RANGE)
    return timeline.duration_ns(evs) / 1e6 / n if evs else None
