"""Device ms a config of the hist grower's routing: every device
operation launched inside the program's ``trees.route`` ranges (one a BFS
step: each sample's child, the exact refine, the node window's updates
and the children's covers), over the traced configs."""

from port_bench.harness import timeline

RANGE = "trees.route"


def read(ctx):
    n = ctx["tracer"].units.get("configs")
    if not n:
        return None
    evs = timeline.under_range(ctx["tracer"].events, RANGE)
    return timeline.duration_ns(evs) / 1e6 / n if evs else None
