"""comb_recode_launches (library surface): kernel launches a call that the
host issues inside the program's ``zc.comb.recode`` span (the
``cudaLaunchKernel`` and ``cuLaunchKernel`` host events that lie within
it), from the traced stretch; None where the program has no such span."""

SPAN = "zc.comb.recode"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def read(r):
    if r.trace is None:
        return None
    spans = [(s, e) for name, s, e in r.trace.host if name == SPAN]
    if not spans:
        return None
    n = sum(1 for name, s, e in r.trace.host if name.startswith(LAUNCHES)
            and any(lo <= s and e <= hi for lo, hi in spans))
    return n / r.trace.calls
