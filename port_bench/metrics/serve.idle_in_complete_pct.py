"""Device idle while a dispatch answers its requests: their futures, the
latency ring, the monitor and the counters.

The share of the traced window in which the device was idle while a
``serve.complete`` range was open (from the port's log of the service's
threads), over the window's length. The collector's and the
dispatchers' ranges overlap in time, so such shares do not add up to
``device.idle_pct.serve``."""

from port_bench.harness import program

RANGE = "serve.complete"


def read(ctx):
    return program.idle_pct_under(ctx, (RANGE,))
