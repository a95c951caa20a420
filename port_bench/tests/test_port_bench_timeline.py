"""The trace's reductions on synthetic timelines: busy and idle from the
union of device intervals, attribution of device work to a range through
the runtime calls made inside it, graph launches, breakdowns."""

from port_bench.harness import timeline as tl
from port_bench.harness.timeline import Ev


def _k(name, s, e, corr):
    return Ev("kernel", name, s, e, -1, corr)


def _rt(s, e, corr, tid=1, name="cudaLaunchKernel"):
    return Ev("runtime", name, s, e, tid, corr)


def _range(name, s, e, tid=1):
    return Ev("range", name, s, e, tid, 0)


def test_busy_is_the_union_of_device_intervals_clipped_to_the_window():
    evs = [_range(tl.WINDOW_RANGE, 100, 200),
           _k("a", 90, 120, 1), _k("b", 110, 130, 2),    # overlap
           _k("c", 150, 160, 3), Ev("memcpy", "m", 190, 260, -1, 4),
           _k("d", 300, 400, 5)]                          # outside
    t0, t1 = tl.window(evs)
    assert (t0, t1) == (100, 200)
    assert tl.busy_ns(evs, t0, t1) == 30 + 10 + 10
    assert tl.idle_gaps(evs, t0, t1) == [(130, 150), (160, 190)]
    idle_pct = 100.0 * (1 - tl.busy_ns(evs, t0, t1) / (t1 - t0))
    assert idle_pct == 50.0


def test_no_device_event_means_all_idle():
    evs = [_range(tl.WINDOW_RANGE, 0, 1000)]
    assert tl.busy_ns(evs, 0, 1000) == 0
    assert tl.idle_gaps(evs, 0, 1000) == [(0, 1000)]


def test_device_work_is_attributed_through_the_launching_calls():
    evs = [_range("port_bench.k1", 10, 20), _rt(12, 13, 7),
           _range("port_bench.k1", 40, 50, tid=2), _rt(41, 42, 8, tid=2),
           _rt(43, 44, 9, tid=1),               # another thread: not in it
           _rt(30, 31, 10),                     # outside every range
           _k("k1", 60, 70, 7), _k("k1", 70, 85, 8), _k("x", 85, 90, 9),
           _k("y", 90, 95, 10)]
    got = tl.under_range(evs, "port_bench.k1")
    assert sorted(e.corr for e in got) == [7, 8]
    assert tl.duration_ns(got) == 25
    assert tl.under_range(evs, "port_bench.none") == []


def test_a_graph_launch_groups_its_kernels():
    evs = [_rt(0, 1, 5, name="cudaGraphLaunch"), _k("walk", 2, 3, 5),
           _k("treeshap_unit_kernel", 3, 9, 5), _k("walk", 4, 5, 6)]
    groups = tl.launches(evs)
    assert {c: len(g) for c, g in groups.items()} == {5: 2, 6: 1}
    assert tl.duration_ns(groups[5]) == 7


def test_breakdowns_name_the_top_ops_and_what_the_host_did_in_gaps():
    evs = [_range(tl.WINDOW_RANGE, 0, 100), _range("port_bench.prep", 0, 40),
           Ev("op", "aten::sort", 60, 90, 1, 0),
           _k("a", 40, 50, 1), _k("a", 55, 60, 2), _k("b", 90, 100, 3)]
    ops = tl.top_device_ops(evs, 0, 100)
    assert ops[0] == ["a", 15e-9] and ops[1] == ["b", 10e-9]
    gaps = dict(tl.top_idle_gaps(evs, 0, 100))
    assert gaps == {"port_bench.prep": 40e-9, "aten::sort": 30e-9,
                    "host": 5e-9}
