"""The program's own spans in a traced window, for the metrics that read
them: the ranges the port opens under a capture (``obs.span`` and
``obs.region``, named by the program), from the trace, and those it
opened on threads the capture does not record (the serving threads; the
profiler records only the thread that started it), from the port's log
of them (``obs.thread_regions``), on the trace's clock. A program that
opens none gives none, and the metrics that read them give nothing."""

from port_bench.harness import timeline


def _thread_log():
    """The port's log of ranges on threads the capture did not record:
    [(name, start, end, thread)], or [] where the program keeps none."""
    try:
        from flake16_framework_tpu_torch.obs import core
    except ImportError:
        return []
    log = getattr(core, "thread_regions", None)
    return log() if log is not None else []


def ranges(evs, names, t0=None, t1=None):
    """[(start, end)] ns, sorted, of the program's ranges named in
    ``names`` that overlap [t0, t1] (all without bounds)."""
    names = set(names)
    out = [(e.start, e.end) for e in evs
           if e.kind == "range" and e.name in names]
    out += [(s, t) for name, s, t, _ in _thread_log() if name in names]
    return sorted((s, t) for s, t in out
                  if (t0 is None or t > t0) and (t1 is None or s < t1))


def union(spans):
    """The disjoint, sorted union of (start, end) intervals."""
    out = []
    for s, t in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        elif t > s:
            out.append((s, t))
    return out


def overlap_ns(a, b):
    """ns in both of two disjoint, sorted interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under_ns(evs, names, t0, t1):
    """ns of [t0, t1] in which no device event ran while a program range
    named in ``names`` was open; None when no such range overlaps the
    window."""
    spans = ranges(evs, names, t0, t1)
    if not spans:
        return None
    inside = union((max(s, t0), min(t, t1)) for s, t in spans)
    return overlap_ns(timeline.idle_gaps(evs, t0, t1), inside)


def idle_pct_under(ctx, names):
    """The share of a metric's traced window, in %, in which the device
    was idle while a program range named in ``names`` was open (on any
    thread; idle counted once where ranges overlap); None when no such
    range overlaps the window."""
    span = ctx["t1"] - ctx["t0"]
    idle = idle_under_ns(ctx["tracer"].events, names, ctx["t0"], ctx["t1"])
    if span <= 0 or idle is None:
        return None
    return 100.0 * idle / span
