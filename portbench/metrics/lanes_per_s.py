"""lanes_per_s: all lanes completed in the window over the window's
seconds, from the first call's start to the last call's end (host clock).
A lane is one (point, scalar) pair of an MSM, one key agreement, one
keypair or one hashed point; the pod cell counts the global batch."""


def read(r):
    return len(r.calls) * r.lanes_per_call / (r.calls[-1][2] - r.calls[0][0])
