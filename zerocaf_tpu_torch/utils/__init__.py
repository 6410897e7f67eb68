"""Utilities: profiling and the cost model of the kernels."""

from . import profiling

__all__ = ["profiling"]
