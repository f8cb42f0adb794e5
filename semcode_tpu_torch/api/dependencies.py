"""API auth + feature gates.

Counterpart of ``semcode_tpu/api/dependencies.py``: optional X-API-Key
header auth (401 on mismatch, no-op when unset) and the telemetry enable
gate, as aiohttp predicates.
"""

from __future__ import annotations

from typing import Optional

from ..settings import AppSettings

API_KEY_HEADER = "X-API-Key"


def check_api_key(config: AppSettings, provided: Optional[str]) -> bool:
    """True when the request may proceed."""
    if not config.api_key:
        return True
    return provided == config.api_key


def telemetry_enabled(config: AppSettings) -> bool:
    return bool(config.telemetry_enabled)
