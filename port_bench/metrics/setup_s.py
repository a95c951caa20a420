"""Set-up time: from the run's start (before torch is imported) to the
window's start: CUDA init, the kernels' load (and build, the first time
in a checkout), the data, and the cell's warm-up. Host clock."""


def read(ctx):
    return ctx["record"]["setup_s"]
