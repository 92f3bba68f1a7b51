"""Shared plumbing for the gRPC transports (abci/grpc.py, rpc/grpc.py):
one JSON wire codec and one bind helper, so the two surfaces cannot
silently diverge."""

from __future__ import annotations

import json


def json_serializer(d: dict) -> bytes:
    return json.dumps(d).encode()


def json_deserializer(b: bytes) -> dict:
    return json.loads(b)


def bind_insecure(server, addr: str) -> str:
    """Bind `host:port` (port 0 = ephemeral); returns the bound addr."""
    host, port = addr.rsplit(":", 1)
    bound = server.add_insecure_port(f"{host}:{port}")
    return f"{host}:{bound}"
