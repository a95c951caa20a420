"""The statistics the end-to-end metrics take over a window: a rate over
all the work and all the time, a percentile over every sample."""

import math


def percentile(values, q):
    """The q-th percentile (0-100) of every value, linear between the two
    nearest ranks (numpy's default). None for no values."""
    vals = sorted(values)
    if not vals:
        return None
    pos = (len(vals) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def rate(n_done, t_start, t_last):
    """Work completed per second, from the window's start to the
    completion of its last piece of work. None when nothing completed."""
    if n_done <= 0 or t_last <= t_start:
        return None
    return n_done / (t_last - t_start)
