"""Defensive env-var knob parsing (the port's copy of the JAX package's
`libs/envknob.py`), shared by the gateway's circuit breaker and the device
daemon client's deadline budgets: a typo'd value warns and falls back to
the default, so an operator's typo never kills node startup or a verify
hot path. An empty or unset variable is simply "use the default", with no
warning.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("libs.envknob")


def env_number(name: str, default, cast=float):
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return cast(raw)
    except ValueError:
        logger.warning("ignoring malformed %s=%r; using %r", name, raw, default)
        return default


def env_str(name: str, default: str, allowed=()):
    """Enumerated string knob: a value outside `allowed` warns and falls
    back (same contract as env_number — a typo never kills startup)."""
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    if allowed and raw not in allowed:
        logger.warning(
            "ignoring unknown %s=%r (allowed: %s); using %r",
            name, raw, "|".join(allowed), default,
        )
        return default
    return raw
