"""The shared method vocabulary of the port's types (zerocaf_tpu/traits.py
counterpart): the reference's traits Identity, ValidityCheck, Square,
Double, Half, Pow, ModSqrt, InvSqrt and SqrtRatioI as runtime-checkable
protocols.  Any type with the listed methods satisfies one; the free
scalar-multiplication functions of ``models/edwards.py`` check ``Double``.

Contract notes, as in the reference:
  * ValidityCheck returns a boolean mask tensor, one entry a lane.
  * SqrtRatioI keeps the 4-case contract:
      (True,  +sqrt(u/v))   if v != 0 and u/v is square
      (True,  0)            if u == 0
      (False, 0)            if v == 0 and u != 0
      (False, +sqrt(i*u/v)) if u/v is nonsquare
    Ristretto encode and decode depend on it.
"""

from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable

import torch


@runtime_checkable
class Identity(Protocol):
    @classmethod
    def identity(cls, shape: tuple = ()) -> "Identity": ...


@runtime_checkable
class ValidityCheck(Protocol):
    """Returns a boolean mask."""

    def is_valid(self) -> torch.Tensor: ...


@runtime_checkable
class Square(Protocol):
    def square(self): ...


@runtime_checkable
class Double(Protocol):
    def double(self): ...


@runtime_checkable
class Half(Protocol):
    def half(self): ...


@runtime_checkable
class Pow(Protocol):
    def pow(self, exp): ...


@runtime_checkable
class ModSqrt(Protocol):
    """Sign-selectable square root."""

    def mod_sqrt(self, sign) -> Tuple[torch.Tensor, "ModSqrt"]: ...


@runtime_checkable
class InvSqrt(Protocol):
    def inv_sqrt(self) -> Tuple[torch.Tensor, "InvSqrt"]: ...


@runtime_checkable
class SqrtRatioI(Protocol):
    """The 4-case contract above."""

    def sqrt_ratio_i(self, v) -> Tuple[torch.Tensor, "SqrtRatioI"]: ...
