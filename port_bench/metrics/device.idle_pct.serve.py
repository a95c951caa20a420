"""The share of the traced window in which no operation ran on the
device: one minus the union of the device events' intervals over the
window's length, from the trace. Nothing when no device event ran."""


def read(ctx):
    span = ctx["t1"] - ctx["t0"]
    if span <= 0 or ctx["busy_ns"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_ns"] / span)
