"""Mean ms an answered request waited in the service's queue, from
``submit`` to the collector taking it into a batch, over every request
the service answered in the run (the batcher's own counters, as
``ScoringService.stats()`` gives them). Nothing where the service keeps
no such count."""


def read(ctx):
    return ctx["state"]["service"].stats().get("queue_wait_ms")
