"""Bounded JSON field decoding for wire-facing types.

Everything decoded from a peer is attacker input: every scalar is type-
and range-checked, and any violation raises ValueError. The bounds are
protocol-level maxima, not policy limits: heights up to 2^62, 2^20
validators or parts, 64-byte hashes.
"""

from __future__ import annotations

MAX_HEIGHT = 1 << 62
MAX_ROUND = 1 << 31
MAX_INDEX = 1 << 20  # validator / part indices and counts
MAX_HASH_BYTES = 64
MAX_TX_BYTES = 1 << 22  # 4 MB, above any block-size policy
MAX_STR = 1 << 10
MAX_TIME_NS = 1 << 62  # about the year 2116 in unix nanoseconds


def int_field(o, key, lo: int, hi: int) -> int:
    v = o.get(key) if isinstance(o, dict) else None
    if type(v) is not int or not (lo <= v <= hi):  # type() also rejects bool
        raise ValueError(f"bad {key!r}: {v!r}")
    return v


def hex_field(o, key, max_bytes: int = MAX_HASH_BYTES) -> bytes:
    v = o.get(key) if isinstance(o, dict) else None
    if not isinstance(v, str) or len(v) > 2 * max_bytes:
        raise ValueError(f"bad {key!r}")
    try:
        return bytes.fromhex(v)
    except ValueError as exc:
        raise ValueError(f"bad {key!r}: not hex") from exc


def dict_field(o, key) -> dict:
    v = o.get(key) if isinstance(o, dict) else None
    if not isinstance(v, dict):
        raise ValueError(f"bad {key!r}")
    return v


def require_dict(o) -> dict:
    """Entry guard for every wire-facing from_json: a list or scalar where
    an object belongs is a ValueError, never a TypeError."""
    if not isinstance(o, dict):
        raise ValueError(f"expected object, got {type(o).__name__}")
    return o


def list_field(o, key, max_len: int) -> list:
    v = o.get(key) if isinstance(o, dict) else None
    if not isinstance(v, list) or len(v) > max_len:
        raise ValueError(f"bad {key!r}")
    return v


def str_field(o, key, max_len: int = MAX_STR) -> str:
    v = o.get(key) if isinstance(o, dict) else None
    if not isinstance(v, str) or len(v) > max_len:
        raise ValueError(f"bad {key!r}")
    return v
