"""call_p90_ms: the 90th percentile of every window call's time, from
handing host bytes to the entry to holding its result's host bytes (host
clock; linear interpolation between order statistics)."""

import numpy as np


def read(r):
    return float(np.percentile([(e - s) * 1e3 for s, _, e in r.calls], 90))
