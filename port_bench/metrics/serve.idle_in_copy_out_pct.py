"""Device idle while a dispatch copies its output to the host (the one
device-to-host crossing of a batch).

The share of the traced window in which the device was idle while a
``serve.copy_out`` range was open (from the port's log of the service's
threads), over the window's length. The collector's and the
dispatchers' ranges overlap in time, so such shares do not add up to
``device.idle_pct.serve``."""

from port_bench.harness import program

RANGE = "serve.copy_out"


def read(ctx):
    return program.idle_pct_under(ctx, (RANGE,))
