"""K1's share of its roofline over the traced configs: the least time of
every ``cum_hists`` call (the frozen byte model, ``harness/work.py``,
from the call's shapes, at the HBM peak) over the device time of every
kernel launched under the call (the benchmark's range where the grower
looks ``cum_hists`` up). Nothing when no call ran on the device."""

from port_bench.harness import timeline, work

RANGE = "port_bench.k1"


def _bound(args, kwargs):
    rel, w, wy, bin_t, n_nodes, n_bins = args
    n_tree, n = rel.shape
    return {"k1_s": work.k1_seconds(n_tree, n, bin_t.shape[-2],
                                    bin_t.numel(), int(n_nodes),
                                    int(n_bins))}


HOOKS = [{"target": "flake16_framework_tpu_torch.ops.trees:cum_hists",
          "range": RANGE, "record": _bound}]


def read(ctx):
    evs = [e for e in timeline.under_range(ctx["tracer"].events, RANGE)
           if e.kind == "kernel"]
    device_s = timeline.duration_ns(evs) / 1e9
    if device_s <= 0:
        return None
    bound_s = sum(c.get("k1_s", 0.0)
                  for c in ctx["tracer"].calls.get(RANGE, []))
    return 100.0 * bound_s / device_s
