"""The pure-Python curve oracle, shared with the JAX package.

``zerocaf_tpu/oracle.py`` imports nothing but ``__future__``, but importing it
as ``zerocaf_tpu.oracle`` would run ``zerocaf_tpu/__init__.py`` and with it
``import jax``.  This module loads the file by path instead, under its own
module name, so the port derives every constant from the same judge without
importing the JAX package.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

PATH = Path(__file__).resolve().parent.parent / "zerocaf_tpu" / "oracle.py"

_NAME = __name__ + "_impl"
_mod = sys.modules.get(_NAME)
if _mod is None:
    _spec = importlib.util.spec_from_file_location(_NAME, PATH)
    _mod = importlib.util.module_from_spec(_spec)
    sys.modules[_NAME] = _mod
    _spec.loader.exec_module(_mod)

globals().update({k: v for k, v in vars(_mod).items() if not k.startswith("__")})
