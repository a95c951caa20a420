"""Device idle ms a config while the sweep prepares a config or resamples
a fold: the traced window's stretches with no device operation that lie
inside the program's ``sweep.prep`` (preprocessing, its transform and
the bin edges) or ``sweep.resample`` (balancing, with its nearest
neighbours) ranges, over the traced configs."""

from port_bench.harness import program

RANGES = ("sweep.prep", "sweep.resample")


def read(ctx):
    n = ctx["tracer"].units.get("configs")
    if not n:
        return None
    idle = program.idle_under_ns(ctx["tracer"].events, RANGES, ctx["t0"],
                                 ctx["t1"])
    return idle / 1e6 / n if idle is not None else None
