"""The gRPC broadcast API (reference: rpc/grpc/api.go:14 BroadcastAPI —
Ping + BroadcastTx — with client/server helpers in
rpc/grpc/client_server.go:15-48).

Same transport redesign as abci/grpc.py: gRPC unary methods under the
reference's service name, bodies in this framework's canonical JSON.
BroadcastTx runs the full broadcast_tx_commit path (CheckTx, then wait
for the tx to land in a block) exactly like the reference's
core.BroadcastTxCommit hand-off.
"""

from __future__ import annotations

from concurrent import futures as _futures

from tendermint_tpu_torch.libs.grpcutil import bind_insecure, json_deserializer as _de, json_serializer as _ser
from tendermint_tpu_torch.libs.service import BaseService

SERVICE = "tendermint.rpc.grpc.BroadcastAPI"


class GRPCBroadcastServer(BaseService):
    """Serves Ping + BroadcastTx against an RPCContext (the same ctx the
    JSON-RPC server uses, so both ports share one behavior)."""

    def __init__(self, addr: str, ctx):
        super().__init__("rpc.grpc")
        import grpc

        self.ctx = ctx
        self._server = grpc.server(_futures.ThreadPoolExecutor(max_workers=4))

        def ping(request: dict, context) -> dict:
            return {}

        def broadcast_tx(request: dict, context) -> dict:
            from tendermint_tpu_torch.rpc.core import handlers

            try:
                res = handlers.broadcast_tx_commit(self.ctx, request["tx"])
            except Exception as exc:  # noqa: BLE001 — surface as payload
                return {"error": str(exc)}
            return {
                "check_tx": res["check_tx"],
                "deliver_tx": res["deliver_tx"],
                "height": res.get("height", 0),
                "hash": res.get("hash", ""),
            }

        handler = {
            "Ping": grpc.unary_unary_rpc_method_handler(
                ping, request_deserializer=_de, response_serializer=_ser
            ),
            "BroadcastTx": grpc.unary_unary_rpc_method_handler(
                broadcast_tx, request_deserializer=_de, response_serializer=_ser
            ),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handler),)
        )
        self.addr = bind_insecure(self._server, addr)

    def on_start(self) -> None:
        self._server.start()

    def on_stop(self) -> None:
        self._server.stop(grace=0.5)


class GRPCBroadcastClient:
    """Client for the broadcast API (rpc/grpc/client_server.go:15-24)."""

    def __init__(self, addr: str, timeout: float = 10.0):
        import grpc

        self._channel = grpc.insecure_channel(addr)
        grpc.channel_ready_future(self._channel).result(timeout=timeout)
        self._ping = self._channel.unary_unary(
            f"/{SERVICE}/Ping", request_serializer=_ser, response_deserializer=_de
        )
        self._btx = self._channel.unary_unary(
            f"/{SERVICE}/BroadcastTx", request_serializer=_ser, response_deserializer=_de
        )

    def ping(self) -> dict:
        return self._ping({})

    def broadcast_tx(self, tx: bytes, timeout: float = 60.0) -> dict:
        return self._btx({"tx": tx.hex()}, timeout=timeout)

    def close(self) -> None:
        self._channel.close()
