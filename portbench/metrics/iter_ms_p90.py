"""iter_ms_p90: the 90th percentile, in ms, of every window iteration's
time, fetch to fetch, over all of them (numpy's linear interpolation)."""

from benchlib.stats import percentile


def read(view):
    return percentile(view.iter_s, 90) * 1e3
