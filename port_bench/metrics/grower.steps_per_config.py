"""BFS steps a config: the program's ``trees.step`` ranges that start in
the traced window (one a pass of the grower's loop, each with one K1
call and one host sync), over the traced configs. Counted from the
ranges the program opens."""

from port_bench.harness import program

RANGE = "trees.step"


def read(ctx):
    n = ctx["tracer"].units.get("configs")
    if not n:
        return None
    steps = sum(1 for s, _ in program.ranges(ctx["tracer"].events, (RANGE,),
                                             ctx["t0"], ctx["t1"])
                if s >= ctx["t0"])
    return steps / n if steps else None
