"""Canonical JSON — the deterministic sign-bytes encoding.

The reference's format (types/canonical_json.go): compact separators, keys
in alphabetical order, byte slices as UPPERCASE hex strings, and signed
payloads wrapped with the chain id:

    {"chain_id":"my_chain","vote":{"block_id":{...},"height":1,...}}
"""

from __future__ import annotations

import json
from typing import Any


def _canonicalize(obj: Any) -> Any:
    if isinstance(obj, (bytes, bytearray)):
        return bytes(obj).hex().upper()
    if isinstance(obj, dict):
        return {k: _canonicalize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canonicalize(v) for v in obj]
    if isinstance(obj, float):
        raise TypeError("floats are not permitted in canonical JSON")
    return obj


def canonical_dumps(obj: Any) -> bytes:
    return json.dumps(
        _canonicalize(obj),
        sort_keys=True,
        separators=(",", ":"),
        ensure_ascii=True,
    ).encode("utf-8")


def sign_bytes(chain_id: str, key: str, payload: Any) -> bytes:
    """SignBytes(chainID, o) equivalent (reference types/signable.go:13-30):
    wrap the canonical payload under its message-kind key with the chain id."""
    return canonical_dumps({"chain_id": chain_id, key: payload})
