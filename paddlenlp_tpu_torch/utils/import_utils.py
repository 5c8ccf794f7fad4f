"""Optional-dependency gating.

The port's copy of ``paddlenlp_tpu/utils/import_utils.py``: whether a package
can be imported, asked without importing it."""

from __future__ import annotations

import importlib.util
from functools import lru_cache

__all__ = ["is_package_available"]


@lru_cache(maxsize=None)
def is_package_available(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:  # dotted name whose parent isn't installed
        return False
