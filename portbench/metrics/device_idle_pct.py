"""device_idle_pct (device): the share of the traced stretch's wall time
in which no operation (kernel, copy, set) runs on the card, from the union
of their intervals (rank 0 on the pod cell)."""


def read(r):
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
