"""Requests answered over the whole window: from its start to the last
answer, the requests in flight at the deadline included. Host clock."""


def read(ctx):
    return ctx["record"].get("serve_rps")
