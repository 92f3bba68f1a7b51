"""JSON-RPC API surface (reference: rpc/).

Three transports, same handlers (rpc/lib/server/handlers.go:26-34):
- POST / with a JSON-RPC 2.0 envelope
- GET /<method>?arg=val URI calls
- WebSocket /websocket with JSON-RPC framing + event subscriptions
"""

from tendermint_tpu_torch.rpc.server import RPCServer
from tendermint_tpu_torch.rpc.client import HTTPClient, LocalClient

__all__ = ["RPCServer", "HTTPClient", "LocalClient"]
