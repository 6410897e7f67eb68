"""<kernel>_roofline (kernels): the least time the chip could take for the
kernel's work in one call, over the kernel's device time a call in the
traced stretch, in %.  The least time is the larger of the work bound and
the byte bound that ``roofline/<kernel>.py`` counts; None where the kernel
does not run in the cell."""

from portbench.trace import name_matcher


def read(r, kernel):
    if r.trace is None:
        return None
    ms = r.trace.device_ms_per_call(name_matcher(kernel))
    bounds = r.bench.roofline(kernel).least_seconds(r)
    if not ms or bounds is None:
        return None
    return 100.0 * max(bounds) / (ms / 1e3)
