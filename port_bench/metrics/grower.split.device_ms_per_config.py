"""Device ms a config of the hist grower's split scan: every device
operation launched inside the program's ``trees.split`` ranges (one a BFS
step: from K1's histogram totals through the split scores, the Extra
Trees thresholds, the feature choice and the split decision), over the
traced configs."""

from port_bench.harness import timeline

RANGE = "trees.split"


def read(ctx):
    n = ctx["tracer"].units.get("configs")
    if not n:
        return None
    evs = timeline.under_range(ctx["tracer"].events, RANGE)
    return timeline.duration_ns(evs) / 1e6 / n if evs else None
