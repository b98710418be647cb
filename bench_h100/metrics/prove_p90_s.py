"""The 90th percentile of the latency of every job in the window (Python's
statistics.quantiles, exclusive method); nothing with fewer than 100 jobs,
so that at least ten lie beyond it."""

import statistics


def read(r):
    if len(r.latencies) < 100:
        return None
    return statistics.quantiles(r.latencies, n=10)[-1]
