"""Faults planted under the timed path, for the tests that show the
comparison fails them.  The benchmark's own runs plant none: only
``harness.run_cell(..., fault=...)`` installs one, and the command line
cannot.

    flip_byte      the first byte of the first answer altered where it is
                   produced
    half_batch     the second half of every batch left out (its inputs
                   zeroed: identity points and zero scalars add nothing)
    unchanged      the answer is the input handed back unchanged
    skip_exchange  the ranks' exchange left out: every all_gather of
                   points returns this rank's own part alone
    flax_on_rank1  rank 1's process imports ``flax``, a module the result
                   must refuse (the test puts a dummy of that name first
                   on the path)
"""

from __future__ import annotations

import importlib

import numpy as np

FAULTS = ("flip_byte", "half_batch", "unchanged", "skip_exchange", "flax_on_rank1")


def install(fault: str | None, driver, traffic, rank: int = 0) -> None:
    if fault is None:
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    dispatch, fetch = driver.dispatch, driver.fetch
    if fault == "flax_on_rank1":
        if rank == 1:
            importlib.import_module("flax")
    elif fault == "skip_exchange":
        from zerocaf_tpu_torch.parallel.comm import Communicator
        Communicator.all_gather_points = lambda self, pts: tuple(
            p.unsqueeze(0) for p in pts)
    elif fault == "half_batch":
        def half(i, args=None):
            args = [a.copy() for a in (args or traffic.batches[i].args)]
            for a in args:
                a[len(a) // 2:] = 0
            return dispatch(i, tuple(args))
        driver.dispatch = half
    elif fault == "flip_byte":
        def flipped(outputs):
            host = fetch(outputs)
            if host is None:
                return None
            first = host[0].copy()
            first.reshape(-1)[0] ^= 1
            return (first,) + tuple(host[1:])
        driver.fetch = flipped
    else:
        last = {}

        def remember(i, args=None):
            last["i"] = i
            return dispatch(i, args)

        def handed_back(outputs):
            host = fetch(outputs)
            if host is None:
                return None
            given = np.ascontiguousarray(traffic.batches[last["i"]].args[0][..., :32])
            same = given[0] if host[0].ndim == 1 else given
            return (same,) + tuple(host[1:])
        driver.dispatch, driver.fetch = remember, handed_back
