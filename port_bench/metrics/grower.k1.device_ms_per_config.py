"""Device ms a config of kernel K1 as the grower calls it: every device
operation launched inside the program's ``trees.k1`` ranges (one
``cum_hists`` call a BFS step), over the traced configs. With the draws,
the split scan and the routing, the grower's stages by the program's own
ranges (against ``grower.device_ms_per_config``, the whole fit)."""

from port_bench.harness import timeline

RANGE = "trees.k1"


def read(ctx):
    n = ctx["tracer"].units.get("configs")
    if not n:
        return None
    evs = timeline.under_range(ctx["tracer"].events, RANGE)
    return timeline.duration_ns(evs) / 1e6 / n if evs else None
