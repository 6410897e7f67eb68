"""The edge set on which ``k_canonical``, its per-lane body and its plain
version are held against Python integers (``test_torch_field_kernels.py``,
``test_torch_field32_host.py``): edge values of (-2^255, 2^255) and limb
vectors with carry slack, modulo p and r, with each mode's operands and
expected reads."""

import numpy as np
import torch

from zerocaf_tpu_torch import oracle as o
from zerocaf_tpu_torch.ops import limb as tl

# modulus name -> (spec, m, the bound of mode "geq"): is_positive's for p,
# r's half for r
MODULI = {"p": (tl.FIELD, o.P, o.POS_RANGE + 1),
          "r": (tl.SCALAR, o.R, (o.R - 1) // 2 + 1)}
MODES = ("limbs", "bytes", "zero", "geq", "eq")


def signed_row(v: int) -> list[int]:
    """v as 21 limbs in [0, 4096) and a signed top limb."""
    return [(v >> (12 * i)) & 4095 for i in range(21)] + [v >> 252]


def cases(m: int, bound: int) -> tuple[np.ndarray, list[int]]:
    """(rows [n, 22] int32, their values): the edge values in signed limbs,
    a little past (-2^255, 2^255) too (+-(64 m - 1), which canonical
    accepts), then 48 limb vectors with carry slack: non-top limbs at -13,
    4109 and +-2^20 among random ones, a top limb that keeps the value
    inside (-2^255, 2^255)."""
    edges = [0, 1, m - 1, m, m + 1, 2 * m, 64 * m - 1, (1 << 255) - 1, 1 << 252,
             1 << 249, o.POS_RANGE - 1, o.POS_RANGE, o.POS_RANGE + 1, bound - 1,
             bound, bound + 1]
    vals = edges + [-v for v in edges if v]
    rows = [signed_row(v) for v in vals]
    rng = np.random.default_rng(34)
    slack = [-13, 4109, 1 << 20, -(1 << 20)]
    for _ in range(48):
        low = [slack[rng.integers(4)] if rng.random() < 0.5 else int(rng.integers(4096))
               for _ in range(21)]
        part = sum(v << (12 * i) for i, v in enumerate(low))
        top = int(rng.integers(-7, 8)) - (part >> 252)
        rows.append(low + [top])
        vals.append(part + (top << 252))
        assert -(1 << 255) < vals[-1] < 1 << 255
    return np.array(rows, np.int32), vals


def other_values(vals: list[int], m: int) -> list[int]:
    """The second operand of mode "eq": the same class (v -+ m) and the
    next value, in turn."""
    return [(v - m if v >= 0 else v + m) if i % 2 == 0 else v + 1
            for i, v in enumerate(vals)]


def mode_args(spec, m: int, bound: int, mode: str, vals: list[int],
              device=None) -> dict:
    """The keyword arguments of ``mode``: the other operand or the bound."""
    if mode == "eq":
        rows = np.array([signed_row(w) for w in other_values(vals, m)], np.int32)
        return {"other": torch.tensor(rows, device=device)}
    if mode == "geq":
        return {"bound": tl.spec_limbs(bound, spec)}
    return {}


def expected(mode: str, vals: list[int], m: int, bound: int) -> list:
    """What ``mode`` reads of each value, as Python lists: canonical limbs,
    32 bytes, or a flag."""
    red = [v % m for v in vals]
    if mode == "limbs":
        return [o.int_to_limbs(v) for v in red]
    if mode == "bytes":
        return [list(v.to_bytes(32, "little")) for v in red]
    if mode == "zero":
        return [v == 0 for v in red]
    if mode == "geq":
        return [v >= bound for v in red]
    return [(v - w) % m == 0 for v, w in zip(vals, other_values(vals, m))]
