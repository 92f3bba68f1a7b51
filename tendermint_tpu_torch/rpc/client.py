"""RPC clients (reference: rpc/client/httpclient.go, localclient.go,
rpc/lib/client/ws_client.go).

HTTPClient speaks JSON-RPC over HTTP; WSClient adds event subscriptions;
LocalClient calls handlers in-process against an RPCContext (no sockets),
which is what tests and in-node tooling use.
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import queue
import socket
import struct
import threading
from urllib.parse import urlsplit

from tendermint_tpu_torch.rpc.core.routes import build_routes


class RPCClientError(Exception):
    pass


class _UnixHTTPConnection(http.client.HTTPConnection):
    """http.client connection whose transport is an AF_UNIX socket —
    the client half of the reference's unix-socket RPC transport
    (rpc/lib/rpc_test.go:40-75 exercises both)."""

    def __init__(self, path: str, timeout: float):
        super().__init__("unix", timeout=timeout)
        self._path = path

    def connect(self):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        s.connect(self._path)
        self.sock = s


class HTTPClient:
    """JSON-RPC over HTTP with per-thread persistent connections:
    a replica's upstream fetch path issues thousands of small POSTs
    and a fresh TCP handshake per request was the dominant cost. Each
    calling thread keeps ONE keep-alive connection (the server side is
    HTTP/1.1 with Content-Length). A connection that turns out dead on
    reuse — server restart, idle EOF — is rebuilt and the request
    retried once; a FRESH connection's failure still raises (the server
    is genuinely down), and a timeout never retries (the request may be
    executing server-side, and a broadcast_tx must not double-submit)."""

    def __init__(self, addr: str, timeout: float = 30.0):
        # addr: "host:port", "http://host:port", or "unix:///path.sock"
        self.timeout = timeout
        self._id = 0
        self._mtx = threading.Lock()
        self._local = threading.local()
        # reused-connection rebuilds that transparently re-sent a request
        self.reconnects = 0
        if addr.startswith("unix://"):
            self.unix_path: str | None = addr[len("unix://"):]
            self.addr = addr
            return
        self.unix_path = None
        if not addr.startswith("http"):
            addr = "http://" + addr
        self.addr = addr.rstrip("/")
        u = urlsplit(self.addr)
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or 80

    def _connect(self):
        if self.unix_path:
            return _UnixHTTPConnection(self.unix_path, self.timeout)
        return http.client.HTTPConnection(
            self._host, self._port, timeout=self.timeout
        )

    def _drop(self, conn) -> None:
        self._local.conn = None
        try:
            conn.close()
        except OSError:
            pass

    @staticmethod
    def _roundtrip(conn, data: bytes) -> tuple[int, bytes, bool]:
        conn.request(
            "POST", "/", body=data,
            headers={"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, raw, not resp.will_close

    def _post(self, data: bytes) -> tuple[int, bytes]:
        conn = getattr(self._local, "conn", None)
        reused = conn is not None
        if conn is None:
            conn = self._connect()
        try:
            status, raw, keep = self._roundtrip(conn, data)
        except TimeoutError:
            self._drop(conn)
            raise
        except (http.client.HTTPException, ConnectionError, OSError):
            self._drop(conn)
            if not reused:
                raise
            with self._mtx:
                self.reconnects += 1
            conn = self._connect()
            try:
                status, raw, keep = self._roundtrip(conn, data)
            except (http.client.HTTPException, ConnectionError, OSError):
                self._drop(conn)
                raise
        if keep:
            self._local.conn = conn
        else:
            self._drop(conn)
        return status, raw

    def call(self, method: str, **params):
        with self._mtx:
            self._id += 1
            id_ = self._id
        req = {
            "jsonrpc": "2.0",
            "id": id_,
            "method": method,
            "params": params,
        }
        status, raw = self._post(json.dumps(req).encode())
        # JSON-RPC errors ride non-200 statuses with a JSON body
        try:
            body = json.loads(raw.decode())
        except ValueError as exc:
            raise RPCClientError(f"HTTP {status}") from exc
        if body.get("error"):
            raise RPCClientError(body["error"])
        return body["result"]

    def close(self) -> None:
        """Close THIS thread's persistent connection (each thread owns
        its own; idle ones die with their thread or at GC)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._drop(conn)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda **params: self.call(name, **params)


class LocalClient:
    """In-process client: handler table against a live RPCContext
    (reference rpc/client/localclient.go)."""

    def __init__(self, ctx, unsafe: bool = False):
        self.ctx = ctx
        self.routes = build_routes(unsafe)

    def call(self, method: str, **params):
        route = self.routes.get(method)
        if route is None:
            raise RPCClientError(f"unknown method {method!r}")
        fn, _known = route
        return fn(self.ctx, **params)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda **params: self.call(name, **params)


class WSClient:
    """Minimal RFC6455 client for the /websocket endpoint: JSON-RPC calls
    and an event queue for subscriptions."""

    def __init__(self, addr: str, timeout: float = 30.0):
        if addr.startswith("unix://"):
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.sock.settimeout(timeout)
            self.sock.connect(addr[len("unix://"):])
            host_hdr = "unix"
        else:
            host, _, port = (
                addr.replace("http://", "").replace("ws://", "").rpartition(":")
            )
            self.sock = socket.create_connection((host, int(port)), timeout=timeout)
            host_hdr = f"{host}:{port}"
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall(
            (
                f"GET /websocket HTTP/1.1\r\nHost: {host_hdr}\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        # consume the 101 response headers
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise RPCClientError("ws handshake failed")
            buf += chunk
        if b"101" not in buf.split(b"\r\n", 1)[0]:
            raise RPCClientError(f"ws handshake rejected: {buf[:200]!r}")
        self.events: queue.Queue = queue.Queue()
        self.responses: queue.Queue = queue.Queue()
        self._id = 0
        self._recv_thread = threading.Thread(
            target=self._recv_loop, daemon=True, name="wsclient.recv"
        )
        self._recv_thread.start()

    # -- frames ------------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("ws closed")
            buf += chunk
        return bytes(buf)

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        mask = os.urandom(4)
        head = bytearray([0x80 | opcode])
        n = len(payload)
        if n < 126:
            head.append(0x80 | n)
        elif n < 1 << 16:
            head.append(0x80 | 126)
            head += struct.pack(">H", n)
        else:
            head.append(0x80 | 127)
            head += struct.pack(">Q", n)
        head += mask
        masked = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
        self.sock.sendall(bytes(head) + masked)

    def _recv_loop(self) -> None:
        try:
            while True:
                b1, b2 = self._read_exact(2)
                opcode = b1 & 0x0F
                length = b2 & 0x7F
                if length == 126:
                    (length,) = struct.unpack(">H", self._read_exact(2))
                elif length == 127:
                    (length,) = struct.unpack(">Q", self._read_exact(8))
                payload = self._read_exact(length)
                if opcode == 0x9:
                    self._send_frame(0xA, payload)
                    continue
                if opcode == 0x8:
                    return
                if opcode not in (0x1, 0x2):
                    continue
                msg = json.loads(payload.decode())
                result = msg.get("result") or {}
                if isinstance(result, dict) and "event" in result:
                    self.events.put(result)
                else:
                    self.responses.put(msg)
        except (ConnectionError, OSError):
            pass

    # -- API ---------------------------------------------------------------

    def call(self, method: str, timeout: float = 10.0, **params):
        self._id += 1
        self._send_frame(
            0x1,
            json.dumps(
                {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
            ).encode(),
        )
        msg = self.responses.get(timeout=timeout)
        if msg.get("error"):
            raise RPCClientError(msg["error"])
        return msg["result"]

    def subscribe(self, event: str) -> None:
        self.call("subscribe", event=event)

    def unsubscribe(self, event: str) -> None:
        self.call("unsubscribe", event=event)

    def next_event(self, timeout: float = 10.0) -> dict:
        return self.events.get(timeout=timeout)

    def close(self) -> None:
        try:
            self._send_frame(0x8, b"")
            self.sock.close()
        except OSError:
            pass
