"""Requests answered in the traced stretch over the store dispatches
(``ExecutableStore.call``, one a microbatch) in it: how many requests the
batcher coalesces. Counted by the benchmark's wrapper on the call."""

RANGE = "port_bench.dispatch"
HOOKS = [{"target":
          "flake16_framework_tpu_torch.serve.store:ExecutableStore.call",
          "range": RANGE}]


def read(ctx):
    calls = len(ctx["tracer"].calls.get(RANGE, []))
    n = ctx["tracer"].units.get("requests")
    return n / calls if calls and n else None
