"""Package version.

Mirrors the reference's resource-file scheme (reference
src/semcode/version.py:13-25) without the importlib.resources indirection.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

_VERSION_FILE = Path(__file__).with_name("VERSION")


@lru_cache(maxsize=1)
def get_version() -> str:
    try:
        return _VERSION_FILE.read_text(encoding="utf-8").strip()
    except OSError:
        return "unknown"


__version__ = get_version()
