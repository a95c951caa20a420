"""Device kernels launched a config in the traced configs (graph nodes
and library kernels included; copies and memsets not), from the trace."""


def read(ctx):
    n = ctx["tracer"].units.get("configs")
    if not n:
        return None
    kernels = sum(1 for e in ctx["tracer"].events if e.kind == "kernel"
                  and ctx["t0"] <= e.start < ctx["t1"])
    return kernels / n if kernels else None
