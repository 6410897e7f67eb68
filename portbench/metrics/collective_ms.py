"""collective_ms (collectives): device ms a call in NCCL's kernels, on
rank 0."""


def read(r):
    if r.trace is None or r.world == 1:
        return None
    ms = r.trace.device_ms_per_call(lambda name: name.startswith("nccl"))
    return ms or None
