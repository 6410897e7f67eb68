"""setup_s: from the process's start to the first timed call: imports,
inputs made from the seed, kernels built or loaded, resident bases
decoded, the warm-up calls (host clock)."""


def read(r):
    return r.setup_s
