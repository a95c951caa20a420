"""Device ms a config of the hist grower's random draws: every device
operation launched inside the program's ``trees.draws`` ranges (the fit's
key splits and bootstrap counts, and each tree batch's per-node feature
and threshold uniforms, ``_node_uniforms``), over the traced configs."""

from port_bench.harness import timeline

RANGE = "trees.draws"


def read(ctx):
    n = ctx["tracer"].units.get("configs")
    if not n:
        return None
    evs = timeline.under_range(ctx["tracer"].events, RANGE)
    return timeline.duration_ns(evs) / 1e6 / n if evs else None
