"""Device ms a store dispatch: every device operation in the traced
stretch (each is a dispatch's copy in, graph replay, clone or copy out:
nothing else runs on the card while the service serves) over the
dispatches (``ExecutableStore.call``) counted by the benchmark's
wrapper."""

from port_bench.harness import timeline

RANGE = "port_bench.dispatch"
HOOKS = [{"target":
          "flake16_framework_tpu_torch.serve.store:ExecutableStore.call",
          "range": RANGE}]


def read(ctx):
    calls = len(ctx["tracer"].calls.get(RANGE, []))
    evs = timeline.device_events(ctx["tracer"].events, ctx["t0"], ctx["t1"])
    return timeline.duration_ns(evs) / 1e6 / calls if calls and evs \
        else None
