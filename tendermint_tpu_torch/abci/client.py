"""ABCI clients: local (in-process, mutexed) and socket (JSON-lines over
TCP), mirroring the reference's abci client library (local_client.go /
socket_client.go as wired by proxy/client.go:14-58).

The async surface matches what the reference's execution pipeline needs:
`deliver_tx_async` queues and returns a ReqRes whose callback fires on
response (state/execution.go:96-101 streams DeliverTx while consensus
proceeds); *_sync calls block.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Callable

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
from tendermint_tpu_torch.libs.service import BaseService


class ReqRes:
    """A pending request/response pair with a completion callback
    (abci client ReqRes)."""

    def __init__(self, req_type: str):
        self.req_type = req_type
        self.response = None
        self._done = False
        # Event allocated only when someone actually blocks in wait():
        # the local client completes synchronously and the async mempool
        # path is callback-driven, so a CheckTx burst was paying one
        # Condition construction per tx for an Event nothing waited on
        self._done_evt: threading.Event | None = None
        self._cb: Callable | None = None
        self._mtx = threading.Lock()

    def set_callback(self, cb: Callable) -> None:
        with self._mtx:
            if self._done:
                cb(self.response)
                return
            self._cb = cb

    def complete(self, response) -> None:
        with self._mtx:
            self.response = response
            self._done = True
            if self._done_evt is not None:
                self._done_evt.set()
            cb = self._cb
        if cb:
            cb(response)

    def done(self) -> bool:
        with self._mtx:
            return self._done

    def wait(self, timeout: float | None = None):
        with self._mtx:
            if self._done:
                return self.response
            if self._done_evt is None:
                self._done_evt = threading.Event()
            evt = self._done_evt
        evt.wait(timeout)
        return self.response


class ABCIClient(BaseService):
    """Common interface of local and socket clients."""

    def set_response_callback(self, cb: Callable[[str, object], None]) -> None:
        raise NotImplementedError

    def error(self) -> Exception | None:
        return None

    # sync
    def echo_sync(self, msg: str) -> str:
        raise NotImplementedError

    def info_sync(self) -> ResponseInfo:
        raise NotImplementedError

    def set_option_sync(self, key: str, value: str) -> str:
        raise NotImplementedError

    def query_sync(self, data: bytes, path: str = "", height: int = 0, prove: bool = False) -> ResponseQuery:
        raise NotImplementedError

    def flush_sync(self) -> None:
        raise NotImplementedError

    def check_tx_sync(self, tx: bytes) -> ResponseCheckTx:
        raise NotImplementedError

    def deliver_tx_sync(self, tx: bytes) -> ResponseDeliverTx:
        raise NotImplementedError

    def init_chain_sync(self, validators: list[ABCIValidator]) -> None:
        raise NotImplementedError

    def begin_block_sync(self, block_hash: bytes, header: Header) -> None:
        raise NotImplementedError

    def end_block_sync(self, height: int) -> ResponseEndBlock:
        raise NotImplementedError

    def commit_sync(self) -> ResponseCommit:
        raise NotImplementedError

    # async
    def check_tx_async(self, tx: bytes) -> ReqRes:
        raise NotImplementedError

    def check_tx_many_async(self, txs: list[bytes]) -> list[ReqRes]:
        """Grouped CheckTx dispatch — the mempool's batched signature
        gate admits whole batches at once, and per-tx dispatch overhead
        (locks, allocations) caps burst throughput well below the
        verifier's rate. Default is the per-tx loop; clients that can
        amortize (LocalClient takes its app lock once) override."""
        return [self.check_tx_async(tx) for tx in txs]

    def deliver_tx_async(self, tx: bytes) -> ReqRes:
        raise NotImplementedError

    def deliver_txs_async(self, txs: list[bytes]) -> list[ReqRes]:
        """Grouped DeliverTx dispatch — the execution
        pipeline hands the whole block's txs at once so a batch-capable
        app (the kvstore sharded apply) sees them together and a local
        client pays ONE lock round trip. Default is the per-tx loop,
        which for the socket client is already pipelined in order."""
        return [self.deliver_tx_async(tx) for tx in txs]

    def flush_async(self) -> ReqRes:
        raise NotImplementedError


class LocalClient(ABCIClient):
    """In-process client: a mutex around the Application, exactly the
    reference's local client concurrency model (one connection = one
    serialized stream of calls)."""

    def __init__(self, app: Application, mtx: threading.RLock | None = None):
        super().__init__("abci.LocalClient")
        self.app = app
        self._app_mtx = mtx or threading.RLock()
        self._res_cb: Callable | None = None

    def set_response_callback(self, cb: Callable) -> None:
        self._res_cb = cb

    def _notify(self, req_type: str, req, res):
        if self._res_cb:
            self._res_cb(req_type, req, res)

    # -- sync --------------------------------------------------------------

    def echo_sync(self, msg: str) -> str:
        return msg

    def info_sync(self) -> ResponseInfo:
        with self._app_mtx:
            return self.app.info()

    def set_option_sync(self, key: str, value: str) -> str:
        with self._app_mtx:
            return self.app.set_option(key, value)

    def query_sync(self, data: bytes, path: str = "", height: int = 0, prove: bool = False) -> ResponseQuery:
        with self._app_mtx:
            return self.app.query(data, path, height, prove)

    def flush_sync(self) -> None:
        pass

    def check_tx_sync(self, tx: bytes) -> ResponseCheckTx:
        with self._app_mtx:
            res = self.app.check_tx(tx)
        self._notify("check_tx", tx, res)
        return res

    def deliver_tx_sync(self, tx: bytes) -> ResponseDeliverTx:
        with self._app_mtx:
            res = self.app.deliver_tx(tx)
        self._notify("deliver_tx", tx, res)
        return res

    def init_chain_sync(self, validators: list[ABCIValidator]) -> None:
        with self._app_mtx:
            self.app.init_chain(validators)

    def begin_block_sync(self, block_hash: bytes, header: Header) -> None:
        with self._app_mtx:
            self.app.begin_block(block_hash, header)

    def end_block_sync(self, height: int) -> ResponseEndBlock:
        with self._app_mtx:
            return self.app.end_block(height)

    def commit_sync(self) -> ResponseCommit:
        with self._app_mtx:
            return self.app.commit()

    # -- async (executed inline; callback semantics preserved) -------------

    def check_tx_async(self, tx: bytes) -> ReqRes:
        rr = ReqRes("check_tx")
        rr.complete(self.check_tx_sync(tx))
        return rr

    def check_tx_many_async(self, txs: list[bytes]) -> list[ReqRes]:
        # one app-lock round trip for the whole batch (vs one per tx);
        # response notifications keep per-tx order, after the lock drops
        # — same ordering check_tx_sync produces for sequential calls
        with self._app_mtx:
            reses = [self.app.check_tx(tx) for tx in txs]
        out = []
        for tx, res in zip(txs, reses):
            self._notify("check_tx", tx, res)
            rr = ReqRes("check_tx")
            rr.complete(res)
            out.append(rr)
        return out

    def deliver_tx_async(self, tx: bytes) -> ReqRes:
        rr = ReqRes("deliver_tx")
        rr.complete(self.deliver_tx_sync(tx))
        return rr

    def deliver_txs_async(self, txs: list[bytes]) -> list[ReqRes]:
        # one app-lock round trip for the whole block; an app exposing
        # deliver_txs (the kvstore sharded apply) gets the batch
        # wholesale, others run the same serial loop under the lock.
        # Notifications keep per-tx order, after the lock drops — same
        # ordering sequential deliver_tx_sync calls produce.
        with self._app_mtx:
            batch = getattr(self.app, "deliver_txs", None)
            if batch is not None:
                reses = batch(list(txs))
            else:
                reses = [self.app.deliver_tx(tx) for tx in txs]
        out = []
        for tx, res in zip(txs, reses):
            self._notify("deliver_tx", tx, res)
            rr = ReqRes("deliver_tx")
            rr.complete(res)
            out.append(rr)
        return out

    def flush_async(self) -> ReqRes:
        rr = ReqRes("flush")
        rr.complete(None)
        return rr


# ---------------------------------------------------------------------------
# socket transport: length-free JSON lines (one request/response per line)
# ---------------------------------------------------------------------------

_RES_TYPES = {
    "info": ResponseInfo,
    "check_tx": ResponseCheckTx,
    "deliver_tx": ResponseDeliverTx,
    "commit": ResponseCommit,
    "query": ResponseQuery,
    "end_block": ResponseEndBlock,
}


class SocketClient(ABCIClient):
    """Remote app over TCP. Requests are pipelined in order on one socket;
    responses come back in order (the ABCI socket protocol's ordering
    contract). JSON-lines framing replaces the reference's varint framing —
    this framework defines its own wire (no cross-compat requirement)."""

    def __init__(self, addr: str):
        super().__init__("abci.SocketClient")
        host, port = addr.rsplit(":", 1)
        self._addr = (host, int(port))
        self._sock: socket.socket | None = None
        self._rfile = None
        self._wmtx = threading.Lock()
        self._pending: list[ReqRes] = []
        self._pending_mtx = threading.Lock()
        self._res_cb: Callable | None = None
        self._err: Exception | None = None

    def on_start(self) -> None:
        self._sock = socket.create_connection(self._addr, timeout=10)
        self._sock.settimeout(None)
        self._rfile = self._sock.makefile("rb")
        threading.Thread(target=self._recv_loop, daemon=True, name="abci-recv").start()

    def on_stop(self) -> None:
        try:
            if self._sock:
                self._sock.close()
        except OSError:
            pass

    def error(self) -> Exception | None:
        return self._err

    def set_response_callback(self, cb: Callable) -> None:
        self._res_cb = cb

    def _send(self, req: dict) -> ReqRes:
        rr = ReqRes(req["type"])
        data = (json.dumps(req) + "\n").encode()
        with self._wmtx:
            with self._pending_mtx:
                self._pending.append(rr)
            self._sock.sendall(data)
        return rr

    def _recv_loop(self) -> None:
        try:
            while True:
                line = self._rfile.readline()
                if not line:
                    break
                obj = json.loads(line)
                with self._pending_mtx:
                    rr = self._pending.pop(0)
                res = self._decode(rr.req_type, obj)
                if self._res_cb and rr.req_type in ("check_tx", "deliver_tx"):
                    # callback contract: tx as raw bytes, and the GLOBAL
                    # callback fires before per-request completion — same
                    # as LocalClient. The mempool's admission path relies
                    # on this order: a lane-full rejection mutates the
                    # response before any broadcast_tx waiter sees it.
                    tx_hex = obj.get("_tx")
                    tx = bytes.fromhex(tx_hex) if tx_hex else None
                    self._res_cb(rr.req_type, tx, res)
                rr.complete(res)
        except Exception as e:
            self._err = e
        # receive loop is done (EOF or error): release every in-flight
        # waiter now instead of letting each block out its full timeout
        if self._err is None:
            self._err = ConnectionError("abci socket closed")
        with self._pending_mtx:
            pending, self._pending = self._pending, []
        for rr in pending:
            rr.complete(None)

    @staticmethod
    def _decode(req_type: str, obj: dict):
        cls = _RES_TYPES.get(req_type)
        if cls is None:
            return obj.get("value")
        return cls.from_json(obj["value"])

    # -- calls -------------------------------------------------------------

    def _call_sync(self, req: dict, timeout: float = 30):
        rr = self._send(req)
        res = rr.wait(timeout)
        if self._err:
            raise self._err
        if res is None and not rr.done():
            raise TimeoutError(f"abci {req['type']} timed out after {timeout}s")
        return res

    def echo_sync(self, msg: str) -> str:
        return self._call_sync({"type": "echo", "msg": msg})

    def info_sync(self) -> ResponseInfo:
        return self._call_sync({"type": "info"})

    def set_option_sync(self, key: str, value: str) -> str:
        return self._call_sync({"type": "set_option", "key": key, "value": value})

    def query_sync(self, data: bytes, path: str = "", height: int = 0, prove: bool = False) -> ResponseQuery:
        return self._call_sync(
            {"type": "query", "data": data.hex(), "path": path, "height": height, "prove": prove}
        )

    def flush_sync(self) -> None:
        self._call_sync({"type": "flush"})

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
        return self._send({"type": "check_tx", "tx": tx.hex()})

    def deliver_tx_async(self, tx: bytes) -> ReqRes:
        return self._send({"type": "deliver_tx", "tx": tx.hex()})

    def flush_async(self) -> ReqRes:
        return self._send({"type": "flush"})


class ABCIServer(BaseService):
    """Serves one Application over TCP (abci socket server). Each
    connection gets its own serialized request stream; the app mutex makes
    concurrent connections safe (the 3-connection proxy relies on this)."""

    def __init__(self, app: Application, addr: str):
        super().__init__("abci.Server")
        host, port = addr.rsplit(":", 1)
        self.app = app
        self._app_mtx = threading.RLock()
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    line = self.rfile.readline()
                    if not line:
                        return
                    try:
                        req = json.loads(line)
                    except json.JSONDecodeError:
                        return
                    res = outer._dispatch(req)
                    out = json.dumps(res) + "\n"
                    self.wfile.write(out.encode())
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, int(port)), Handler)
        self.addr = f"{host}:{self._server.server_address[1]}"

    def on_start(self) -> None:
        threading.Thread(
            target=self._server.serve_forever, daemon=True, name="abci-server"
        ).start()

    def on_stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def _dispatch(self, req: dict) -> dict:
        with self._app_mtx:
            return dispatch_request(self.app, req)


def dispatch_request(app: Application, req: dict) -> dict:
    """One ABCI request (the JSON wire dicts SocketClient/GRPCClient
    build) against an Application. Caller holds the app mutex. Shared by
    the socket server and the gRPC server (abci/grpc.py)."""
    t = req["type"]
    if t == "echo":
        return {"value": req.get("msg", "")}
    if t == "flush":
        return {"value": None}
    if t == "info":
        return {"value": app.info().to_json()}
    if t == "set_option":
        return {"value": app.set_option(req["key"], req["value"])}
    if t == "query":
        return {
            "value": app.query(
                bytes.fromhex(req.get("data", "")),
                req.get("path", ""),
                req.get("height", 0),
                req.get("prove", False),
            ).to_json()
        }
    if t == "check_tx":
        return {"value": app.check_tx(bytes.fromhex(req["tx"])).to_json(), "_tx": req["tx"]}
    if t == "deliver_tx":
        return {"value": app.deliver_tx(bytes.fromhex(req["tx"])).to_json(), "_tx": req["tx"]}
    if t == "init_chain":
        app.init_chain([ABCIValidator.from_json(v) for v in req.get("validators", [])])
        return {"value": None}
    if t == "begin_block":
        app.begin_block(bytes.fromhex(req["hash"]), Header.from_json(req["header"]))
        return {"value": None}
    if t == "end_block":
        return {"value": app.end_block(req["height"]).to_json()}
    if t == "commit":
        return {"value": app.commit().to_json()}
    return {"value": None, "error": f"unknown request {t}"}
