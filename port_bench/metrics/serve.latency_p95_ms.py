"""The 95th percentile of every answered request's latency over the
whole window of the traced run, timed on the client from just before
``submit`` to the poll that sees the answer (the profiled stretch is a
thirtieth of the window). Host clock. Beside the rate rather than an
end-to-end metric of its own: its run-to-run spread is too wide for a
bound."""


def read(ctx):
    return ctx["record"].get("serve_p95_ms")
