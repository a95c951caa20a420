"""Device ms a config of everything the sweep launches under its
preprocessing (``fit_preprocess``, ``transform``), the bin edges
(``quantile_edges``) and the resampler (``resample``, with its nearest
neighbours), each call wrapped in the benchmark's range where the sweep
looks it up."""

from port_bench.harness import timeline

RANGE = "port_bench.prep"
HOOKS = [{"target": f"flake16_framework_tpu_torch.{t}", "range": RANGE}
         for t in ("parallel.sweep:fit_preprocess", "parallel.sweep:transform",
                   "parallel.sweep:resample", "ops.trees:quantile_edges")]


def read(ctx):
    n = ctx["tracer"].units.get("configs")
    if not n:
        return None
    evs = timeline.under_range(ctx["tracer"].events, RANGE)
    return timeline.duration_ns(evs) / 1e6 / n if evs else None
