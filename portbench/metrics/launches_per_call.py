"""launches_per_call (limb engine): device kernels a call in the traced
stretch (rank 0 on the pod cell)."""


def read(r):
    if r.trace is None:
        return None
    return len(r.trace.kernels()) / r.trace.calls
