"""The share of the traced window in which the device was idle while a
dispatch was open: stretches with no device operation inside the
program's ``serve.dispatch`` ranges (on the dispatcher threads, from the
port's log of them), over the window's length. The idle that the
dispatch path itself leaves, as against idle with nothing in dispatch
(``device.idle_pct.serve`` is both)."""

from port_bench.harness import program

RANGE = "serve.dispatch"


def read(ctx):
    return program.idle_pct_under(ctx, (RANGE,))
