"""Mean ms an answered request's batch waited between the collector
taking it and the start of its dispatch (the handoff to a free
dispatcher), over every request the service answered in the run (the
batcher's own counters, as ``ScoringService.stats()`` gives them).
Nothing where the service keeps no such count."""


def read(ctx):
    return ctx["state"]["service"].stats().get("handoff_wait_ms")
