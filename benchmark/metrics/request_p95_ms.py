"""The 95th percentile of every request of the window, from its submission
to its answer on the host, in ms."""

import statistics


def read(window):
    ms = [(r.t1 - r.t0) * 1e3 for r in window.records]
    return statistics.quantiles(ms, n=100, method="inclusive")[94] if len(ms) > 1 else ms[0]
