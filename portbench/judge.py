"""Whether the timed calls answered right: every answer that a run keeps is
compared with the plain reference once the window has closed.

During the window each call leaves a small record (``capture``): an MSM's
encoding and its ok flag; for lane-wise ops the answers of the lanes drawn
from the seed for that call (``Traffic.sample_lanes``) and the whole ok
mask.  ``judge`` then counts

    wrong_answers  compared answers whose bytes differ from the reference's
                   (an invalid dh lane's answer is garbage and not compared)
    wrong_ok       lanes whose ok flag differs from the reference's decode
    compared       answers compared

Both counts are exact comparisons with the limit 0.
"""

from __future__ import annotations

import numpy as np

LIMITS = {"wrong_answers": ("<=", 0), "wrong_ok": ("<=", 0), "compared": (">=", 1)}


def capture(traffic, call: int, batch: int, host) -> tuple:
    """The part of one call's host outputs that ``judge`` reads."""
    if traffic.op == "msm":
        ok = bool(host[1]) if len(host) > 1 else None
        return (batch, host[0].tobytes(), ok)
    lanes = traffic.sample_lanes(call)
    answers = tuple(o[lanes].copy() for o in host if o.ndim == 2)
    ok = np.packbits(host[1]) if traffic.op == "dh" else None
    return (batch, lanes, answers, ok)


def judge(traffic, records) -> tuple[dict, int]:
    """-> ({check: value}, calls with any wrong answer or ok flag)."""
    wrong = wrong_ok = compared = failed = 0
    memo: dict = {}
    for rec in records:
        bad = bad_ok = 0
        if traffic.op == "msm":
            batch, wire, ok = rec
            bad = int(wire != traffic.aggregate(batch))
            bad_ok = int(ok is False)
            compared += 1
        else:
            batch, lanes, answers, ok = rec
            expect_ok = traffic.batches[batch].ok
            if ok is not None:
                got = np.unpackbits(ok)[: traffic.batch].astype(bool)
                bad_ok = int((got != expect_ok).sum())
            for j, lane in enumerate(lanes.tolist()):
                if expect_ok is not None and not expect_ok[lane]:
                    continue
                if (batch, lane) not in memo:
                    memo[batch, lane] = traffic.lane_answer(batch, lane)
                bad += tuple(a[j].tobytes() for a in answers) != memo[batch, lane]
                compared += 1
        wrong += bad
        wrong_ok += bad_ok
        failed += bad + bad_ok > 0
    return {"wrong_answers": wrong, "wrong_ok": wrong_ok,
            "compared": compared}, failed


def passed(checks: dict) -> bool:
    for name, (rule, limit) in LIMITS.items():
        v = checks[name]
        if not (v <= limit if rule == "<=" else v >= limit):
            return False
    return True


def lines(checks: dict) -> list[str]:
    return [f"{name}: {checks[name]} (limit {rule} {limit})"
            for name, (rule, limit) in LIMITS.items()]


def with_limits(checks: dict) -> dict:
    return {name: {"value": checks[name], "limit": limit, "rule": rule}
            for name, (rule, limit) in LIMITS.items()}
