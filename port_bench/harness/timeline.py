"""The traced window as one list of events, and its reductions.

An event is (kind, name, start, end, tid, corr), times in ns on the
profiler's one clock: ``kernel``, ``memcpy`` and ``memset`` ran on the
device; ``runtime`` is a CUDA runtime or driver call on the host (a
launch, a graph launch, a copy, a synchronize); ``range`` is a
``record_function`` range the benchmark opened (the profiler's copy of a
range on the device's timeline is dropped); ``op`` any other host
event. A device event carries the correlation id of the runtime call that
launched it (a graph's kernels carry their graph launch's)."""

import bisect
from typing import NamedTuple

import numpy as np

DEVICE_KINDS = ("kernel", "memcpy", "memset")
RANGE_PREFIX = "port_bench."
WINDOW_RANGE = RANGE_PREFIX + "window"


class Ev(NamedTuple):
    kind: str
    name: str
    start: int
    end: int
    tid: int
    corr: int


def _device_kind(name):
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def from_kineto(prof):
    """The events of a finished ``torch.profiler.profile``, from its raw
    kineto events (building the profiler's host event tree takes minutes
    at the sizes traced here)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        if name.startswith(RANGE_PREFIX) or (
                e.device_type() == DeviceType.CUDA and e.is_user_annotation()):
            if e.device_type() != DeviceType.CUDA:
                out.append(Ev("range", name, start, end,
                              int(e.start_thread_id()), 0))
            continue
        if e.device_type() == DeviceType.CUDA:
            corr = int(e.correlation_id()) or int(e.linked_correlation_id())
            out.append(Ev(_device_kind(name), name, start, end, -1, corr))
        elif e.is_user_annotation():
            out.append(Ev("range", name, start, end,
                          int(e.start_thread_id()), 0))
        elif name.startswith(("cuda", "cu")) and e.correlation_id():
            out.append(Ev("runtime", name, start, end,
                          int(e.start_thread_id()), int(e.correlation_id())))
        else:
            out.append(Ev("op", name, start, end, int(e.start_thread_id()),
                          0))
    return out


def window(evs, name=WINDOW_RANGE):
    """(start, end) ns of the traced window's range."""
    spans = [(e.start, e.end) for e in evs
             if e.kind == "range" and e.name == name]
    if not spans:
        raise ValueError(f"the trace has no {name!r} range")
    return min(s for s, _ in spans), max(t for _, t in spans)


def device_events(evs, t0=None, t1=None):
    """The device events that overlap [t0, t1] (all without bounds)."""
    return [e for e in evs if e.kind in DEVICE_KINDS
            and (t0 is None or e.end > t0) and (t1 is None or e.start < t1)]


def busy_ns(evs, t0, t1):
    """ns of [t0, t1] in which any device event ran: the union of their
    intervals, clipped to the window."""
    spans = sorted((max(e.start, t0), min(e.end, t1))
                   for e in device_events(evs, t0, t1))
    total = 0
    cur_s = cur_e = None
    for s, t in spans:
        if t <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(evs, t0, t1):
    """[(start, end)] of the stretches of [t0, t1] where no device event
    ran."""
    spans = sorted((max(e.start, t0), min(e.end, t1))
                   for e in device_events(evs, t0, t1))
    gaps, cur = [], t0
    for s, t in spans:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if cur < t1:
        gaps.append((cur, t1))
    return gaps


def under_range(evs, range_name):
    """The device events launched by runtime calls made inside a range
    of that name: on the range's thread where the trace gives the runtime
    calls that thread's id, else by time alone."""
    ranges = [e for e in evs if e.kind == "range" and e.name == range_name]
    if not ranges:
        return []
    runtime = sorted((e for e in evs if e.kind == "runtime"),
                     key=lambda e: e.start)
    starts = [e.start for e in runtime]
    tids = {e.tid for e in runtime}
    corrs = set()
    for r in ranges:
        same = r.tid in tids
        for e in runtime[bisect.bisect_left(starts, r.start):
                         bisect.bisect_right(starts, r.end)]:
            if e.end <= r.end and (not same or e.tid == r.tid):
                corrs.add(e.corr)
    return [e for e in evs if e.kind in DEVICE_KINDS and e.corr in corrs]


def launches(evs):
    """{correlation id: [device events]}: the device work of each
    launch (one kernel, or every node of a graph replay)."""
    out = {}
    for e in evs:
        if e.kind in DEVICE_KINDS:
            out.setdefault(e.corr, []).append(e)
    return out


def duration_ns(evs):
    return sum(e.end - e.start for e in evs)


def top_device_ops(evs, t0, t1, k=10):
    """[[name, seconds]] of the k device operations that took the most
    time in the window, summed by name."""
    by = {}
    for e in device_events(evs, t0, t1):
        by[e.name] = by.get(e.name, 0) + (min(e.end, t1) - max(e.start, t0))
    top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[name, ns / 1e9] for name, ns in top]


def top_idle_gaps(evs, t0, t1, k=10, labelled=256):
    """[[label, seconds]] of the longest idle gaps by what the host was
    doing: each of the ``labelled`` longest gaps is labelled by the
    innermost benchmark range open at its middle (else the longest host
    event there, else "host"), summed by label, the k largest."""
    gaps = sorted(idle_gaps(evs, t0, t1), key=lambda g: g[0] - g[1])
    host = [e for e in evs if e.kind in ("range", "op", "runtime")
            and e.name != WINDOW_RANGE]
    if not host:
        host = [Ev("op", "host", t0, t1, 0, 0)]
    starts = np.asarray([e.start for e in host], np.int64)
    ends = np.asarray([e.end for e in host], np.int64)
    spans = ends - starts
    is_range = np.asarray([e.kind == "range" for e in host])
    by = {}
    for s, t in gaps[:labelled]:
        mid = (s + t) // 2
        live = (starts <= mid) & (ends > mid)
        if (live & is_range).any():
            ix = np.flatnonzero(live & is_range)
            label = host[ix[np.argmin(spans[ix])]].name
        elif live.any():
            ix = np.flatnonzero(live)
            label = host[ix[np.argmax(spans[ix])]].name
        else:
            label = "host"
        by[label] = by.get(label, 0) + (t - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[label, ns / 1e9] for label, ns in top]
