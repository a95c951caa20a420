"""Configs completed (each a whole 10-fold CV, its counts on the host)
over the time from the window's start to the completion of the last.
Host clock."""


def read(ctx):
    return ctx["record"].get("configs_per_s")
