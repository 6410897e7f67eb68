"""dispatch_ms (serving): the host's time from handing the inputs to the
entry to its return, before the wait for the result; the median over the
run's window calls (host clock)."""

import statistics


def read(r):
    return statistics.median((d - s) * 1e3 for s, d, _ in r.calls)
