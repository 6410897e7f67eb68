"""comb_recode_host_ms (library surface): host ms a call inside the
program's ``zc.comb.recode`` span, the comb's digit recoding
(``Scalar.windows`` in ``EdwardsPoint.basepoint_mul``), from the traced
stretch; None where the program has no such span."""

SPAN = "zc.comb.recode"


def read(r):
    if r.trace is None:
        return None
    spans = [e - s for name, s, e in r.trace.host if name == SPAN]
    if not spans:
        return None
    return sum(spans) / 1e6 / r.trace.calls
