"""Device idle while the executable store copies a dispatch's rows into
its CUDA graph's input.

The share of the traced window in which the device was idle while a
``store.copy_in`` range was open (from the port's log of the service's
threads), over the window's length. The collector's and the
dispatchers' ranges overlap in time, so such shares do not add up to
``device.idle_pct.serve``."""

from port_bench.harness import program

RANGE = "store.copy_in"


def read(ctx):
    return program.idle_pct_under(ctx, (RANGE,))
