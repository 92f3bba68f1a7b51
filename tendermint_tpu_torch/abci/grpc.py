"""ABCI over gRPC (reference: the types.proto ABCIApplication service and
the gRPC client/server wired by proxy/client.go:40-58 and
abci/server/grpc_server.go).

Transport redesign, same surface: the reference serializes with protobuf
messages; this framework's wire is its canonical JSON (the documented
ABCI framing redesign — see abci/client.py), carried here in gRPC
unary-unary methods registered under the same service/method names the
reference exposes (/tendermint.abci.ABCIApplication/CheckTx, ...). gRPC
provides the HTTP/2 transport, deadlines, and multiplexing; request and
response bodies are the exact dicts the socket transport uses, so both
remote transports share one dispatch (client.dispatch_request) and one
response decode table.

The ordering contract ABCI requires (responses complete in request
order per connection — the mempool recheck path depends on it) is
preserved by serializing async calls through a single worker thread, the
same trade the reference's gRPC client makes (grpc_client.go notes it is
the slower, simpler option next to the pipelined socket client).
"""

from __future__ import annotations

import queue
import threading
from concurrent import futures as _futures
from typing import Callable

from tendermint_tpu_torch.abci.client import (
    _RES_TYPES,
    ABCIClient,
    ReqRes,
    dispatch_request,
)
from tendermint_tpu_torch.abci.types import (
    ABCIValidator,
    Application,
    Header,
    ResponseCheckTx,
    ResponseCommit,
    ResponseDeliverTx,
    ResponseEndBlock,
    ResponseInfo,
    ResponseQuery,
)
from tendermint_tpu_torch.libs.grpcutil import bind_insecure, json_deserializer as _de, json_serializer as _ser
from tendermint_tpu_torch.libs.service import BaseService

SERVICE = "tendermint.abci.ABCIApplication"

# request-type tag <-> gRPC method name (the reference service's methods)
_METHOD_FOR = {
    "echo": "Echo",
    "flush": "Flush",
    "info": "Info",
    "set_option": "SetOption",
    "deliver_tx": "DeliverTx",
    "check_tx": "CheckTx",
    "query": "Query",
    "commit": "Commit",
    "init_chain": "InitChain",
    "begin_block": "BeginBlock",
    "end_block": "EndBlock",
}


class GRPCServer(BaseService):
    """Serves one Application over gRPC; same dispatch + app-mutex model
    as the socket ABCIServer."""

    def __init__(self, app: Application, addr: str):
        super().__init__("abci.GRPCServer")
        import grpc

        self.app = app
        self._app_mtx = threading.RLock()
        self._server = grpc.server(_futures.ThreadPoolExecutor(max_workers=4))

        def handler_for(req_type: str):
            def handle(request: dict, context) -> dict:
                request = dict(request)
                request["type"] = req_type
                with self._app_mtx:
                    return dispatch_request(self.app, request)

            return grpc.unary_unary_rpc_method_handler(
                handle, request_deserializer=_de, response_serializer=_ser
            )

        self._server.add_generic_rpc_handlers(
            (
                grpc.method_handlers_generic_handler(
                    SERVICE,
                    {m: handler_for(t) for t, m in _METHOD_FOR.items()},
                ),
            )
        )
        self.addr = bind_insecure(self._server, addr)

    def on_start(self) -> None:
        self._server.start()

    def on_stop(self) -> None:
        self._server.stop(grace=0.5)


class GRPCClient(ABCIClient):
    """Remote app over gRPC; drop-in for SocketClient (the `abci: grpc`
    config path, proxy/client.go:40-58)."""

    def __init__(self, addr: str, timeout: float = 30.0):
        super().__init__("abci.GRPCClient")
        self._addr = addr
        self._timeout = timeout
        self._channel = None
        self._stubs: dict[str, Callable] = {}
        self._res_cb: Callable | None = None
        self._err: Exception | None = None
        # single worker preserves the per-connection ordering contract
        self._q: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None

    def on_start(self) -> None:
        import grpc

        self._channel = grpc.insecure_channel(self._addr)
        grpc.channel_ready_future(self._channel).result(timeout=10)
        for t, m in _METHOD_FOR.items():
            self._stubs[t] = self._channel.unary_unary(
                f"/{SERVICE}/{m}",
                request_serializer=_ser,
                response_deserializer=_de,
            )
        self._worker = threading.Thread(
            target=self._worker_loop, daemon=True, name="abci-grpc-worker"
        )
        self._worker.start()

    def on_stop(self) -> None:
        self._q.put(None)
        if self._channel is not None:
            self._channel.close()

    def error(self) -> Exception | None:
        return self._err

    def set_response_callback(self, cb: Callable) -> None:
        self._res_cb = cb

    # -- plumbing ----------------------------------------------------------

    def _call(self, req: dict):
        import grpc

        try:
            obj = self._stubs[req["type"]](req, timeout=self._timeout)
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.DEADLINE_EXCEEDED:
                raise TimeoutError(
                    f"abci {req['type']} timed out after {self._timeout}s"
                ) from e
            raise
        cls = _RES_TYPES.get(req["type"])
        res = cls.from_json(obj["value"]) if cls else obj.get("value")
        if self._res_cb and req["type"] in ("check_tx", "deliver_tx"):
            self._res_cb(req["type"], bytes.fromhex(req["tx"]), res)
        return res

    def _worker_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            rr, req = item
            try:
                rr.complete(self._call(req))
            except Exception as e:  # noqa: BLE001 — one failed RPC kills
                # the client loudly, the SocketClient contract: a silent
                # half-broken client would wedge the mempool recheck cursor
                self._err = e
                rr.complete(None)
                while True:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if nxt is None:
                        return
                    nxt[0].complete(None)

    def _call_sync(self, req: dict):
        # a dead client (worker killed by an async failure) fails every
        # subsequent call; a healthy one propagates only ITS OWN errors
        if self._err:
            raise self._err
        return self._call(req)

    def _call_async(self, req: dict) -> ReqRes:
        rr = ReqRes(req["type"])
        self._q.put((rr, req))
        return rr

    # -- calls (same wire dicts as SocketClient) ---------------------------

    def echo_sync(self, msg: str) -> str:
        return self._call_sync({"type": "echo", "msg": msg})

    def info_sync(self) -> ResponseInfo:
        return self._call_sync({"type": "info"})

    def set_option_sync(self, key: str, value: str) -> str:
        return self._call_sync({"type": "set_option", "key": key, "value": value})

    def query_sync(
        self, data: bytes, path: str = "", height: int = 0, prove: bool = False
    ) -> ResponseQuery:
        return self._call_sync(
            {"type": "query", "data": data.hex(), "path": path, "height": height, "prove": prove}
        )

    def flush_sync(self) -> None:
        # drain the async worker: flush's contract is "everything queued
        # before this point has completed" — a timeout must raise, not
        # silently succeed (the mempool recheck cursor depends on it)
        if self._err:
            raise self._err
        rr = ReqRes("flush")
        self._q.put((rr, {"type": "flush"}))
        rr.wait(self._timeout)
        if not rr.done():
            raise TimeoutError(f"abci flush timed out after {self._timeout}s")
        if self._err:
            raise self._err

    def check_tx_sync(self, tx: bytes) -> ResponseCheckTx:
        return self._call_sync({"type": "check_tx", "tx": tx.hex()})

    def deliver_tx_sync(self, tx: bytes) -> ResponseDeliverTx:
        return self._call_sync({"type": "deliver_tx", "tx": tx.hex()})

    def init_chain_sync(self, validators: list[ABCIValidator]) -> None:
        self._call_sync(
            {"type": "init_chain", "validators": [v.to_json() for v in validators]}
        )

    def begin_block_sync(self, block_hash: bytes, header: Header) -> None:
        self._call_sync(
            {"type": "begin_block", "hash": block_hash.hex(), "header": header.to_json()}
        )

    def end_block_sync(self, height: int) -> ResponseEndBlock:
        return self._call_sync({"type": "end_block", "height": height})

    def commit_sync(self) -> ResponseCommit:
        return self._call_sync({"type": "commit"})

    def check_tx_async(self, tx: bytes) -> ReqRes:
        return self._call_async({"type": "check_tx", "tx": tx.hex()})

    def deliver_tx_async(self, tx: bytes) -> ReqRes:
        return self._call_async({"type": "deliver_tx", "tx": tx.hex()})

    def flush_async(self) -> ReqRes:
        rr = ReqRes("flush")
        self._q.put((rr, {"type": "flush"}))
        return rr
