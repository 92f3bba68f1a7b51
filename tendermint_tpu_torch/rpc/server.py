"""JSON-RPC server: HTTP POST + GET URI + WebSocket subscriptions
(reference: rpc/lib/server/handlers.go, http_server.go).

One ThreadingHTTPServer serves all three transports:
- POST /            JSON-RPC 2.0 envelope
- GET  /<method>    params from the query string
- GET  /websocket   RFC6455 upgrade; JSON-RPC frames + subscribe/
                    unsubscribe methods that stream node events
                    (handlers.go:351-630)

The listen address may be TCP ("host:port", "tcp://host:port") or a unix
socket ("unix:///path.sock", or a bare filesystem path) — the reference
rpc/lib serves and tests both (rpc/lib/server/http_server.go:20-40,
rpc/lib/rpc_test.go:40-75); all three transports ride either listener.
"""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlparse

from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.rpc import admission as adm
from tendermint_tpu_torch.rpc.core.handlers import RPCError
from tendermint_tpu_torch.rpc.core.routes import build_routes

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def is_unix_laddr(laddr: str) -> bool:
    """Is this listen address a unix-socket path? Accepts the explicit
    unix:// scheme and bare filesystem paths (what node._parse_laddr
    yields after stripping the scheme)."""
    return laddr.startswith("unix://") or (
        "/" in laddr and ":" not in laddr
    )


class _UnixThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer over AF_UNIX. HTTPServer.server_bind assumes a
    (host, port) address tuple and BaseHTTPRequestHandler.address_string
    indexes client_address — both break on unix sockets, so bind and
    accept are overridden to present tuple-shaped addresses."""

    address_family = socket.AF_UNIX

    def server_bind(self):
        import os as _os
        import stat as _stat

        # reclaim a stale socket from a previous run — but never delete a
        # NON-socket: a mistyped laddr pointing at a real file must fail
        # at bind, not silently destroy the file
        try:
            st = _os.stat(self.server_address)
            if _stat.S_ISSOCK(st.st_mode):
                _os.unlink(self.server_address)
        except (FileNotFoundError, TypeError):
            pass
        self.socket.bind(self.server_address)
        self.server_name = "unix"
        self.server_port = 0

    def get_request(self):
        conn, _ = self.socket.accept()
        return conn, ("unix", 0)


def _json_default(obj):
    to_json = getattr(obj, "to_json", None)
    if to_json is not None:
        return to_json()
    if isinstance(obj, bytes):
        return obj.hex().upper()
    return repr(obj)


def _dumps(obj) -> bytes:
    return json.dumps(obj, default=_json_default).encode()


def _coerce_params(params: dict, known: list[str]) -> dict:
    out = {}
    for k, v in params.items():
        if k not in known:
            raise RPCError(f"unknown parameter {k!r} (expected {known})")
        out[k] = v
    return out


class RPCServer(BaseService):
    def __init__(self, laddr: str, ctx, unsafe: bool = False, routes=None):
        super().__init__(name="rpc.server")
        self.ctx = ctx
        # routes override: the replica daemon serves the read
        # surface off its verified cache with the same transports/admission
        self.routes = build_routes(unsafe) if routes is None else dict(routes)
        # ingress admission (rpc/admission.py): the node wires
        # a shared controller (node.rpc_admission) so telemetry and the
        # load-shed ladder see it; bare harnesses get a private default
        node = getattr(ctx, "node", None)
        self.admission = (
            getattr(node, "rpc_admission", None) or adm.AdmissionController()
        )
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through our logger
                server.logger.debug(fmt, *args)

            # -- ingress admission ------------------------------

            def handle(self):
                """Connection-cap gate ahead of any HTTP parsing: over
                budget, the flood gets one cheap typed 503 and the thread
                exits — never a parked worker."""
                admit = server.admission.conn_acquire()
                if not admit:
                    # send_response needs these before a request is parsed
                    self.requestline = ""
                    self.request_version = self.protocol_version
                    self.command = ""
                    try:
                        self._shed(admit)
                    except OSError:
                        pass
                    self.close_connection = True
                    return
                try:
                    super().handle()
                finally:
                    server.admission.conn_release()

            def _shed(self, admit: adm.Admit, id_=None) -> None:
                """Typed shed response: HTTP 429/503, Retry-After, and a
                stable `shed:<reason>` JSON-RPC error string."""
                body = _dumps({
                    "jsonrpc": "2.0", "id": id_, "result": None,
                    "error": f"shed:{admit.reason}",
                })
                self.send_response(admit.status)
                self.send_header("Retry-After",
                                 adm.retry_after_header(admit.retry_after))
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            @staticmethod
            def _request_kind(method: str) -> str:
                # writes reach the mempool's lanes even under shed-reads;
                # everything else on the method surface is a read
                return "write" if method.startswith("broadcast_tx") else "read"

            def _respond(self, payload: dict, status: int = 200) -> None:
                body = _dumps(payload)
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _rpc_result(self, id_, result) -> None:
                self._respond({"jsonrpc": "2.0", "id": id_, "result": result, "error": ""})

            def _rpc_error(self, id_, message: str, status: int = 500) -> None:
                self._respond(
                    {"jsonrpc": "2.0", "id": id_, "result": None, "error": message},
                    status=status,
                )

            def _call(self, method: str, params: dict):
                route = server.routes.get(method)
                if route is None:
                    raise RPCError(f"unknown RPC method {method!r}")
                fn, known = route
                return fn(server.ctx, **_coerce_params(params, known))

            # -- POST JSON-RPC (handlers.go:100-160) -----------------------

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                id_ = None
                admitted = False
                try:
                    req = json.loads(raw.decode())
                    id_ = req.get("id")
                    admit = server.admission.admit_request(
                        self.client_address[0],
                        self._request_kind(req.get("method", "")),
                    )
                    if not admit:
                        self._shed(admit, id_)
                        return
                    admitted = True
                    params = req.get("params") or {}
                    if isinstance(params, list):
                        route = server.routes.get(req.get("method", ""))
                        names = route[1] if route else []
                        params = dict(zip(names, params))
                    result = self._call(req["method"], params)
                    self._rpc_result(id_, result)
                except RPCError as exc:
                    self._rpc_error(id_, str(exc), status=400)
                except Exception as exc:  # noqa: BLE001 — surface, don't die
                    server.logger.exception("rpc error")
                    self._rpc_error(id_, f"{type(exc).__name__}: {exc}")
                finally:
                    if admitted:
                        server.admission.request_done()

            # -- GET URI + websocket (handlers.go:229-300, 351+) -----------

            def do_GET(self):
                parsed = urlparse(self.path)
                if parsed.path == "/websocket":
                    admit = server.admission.admit_request(
                        self.client_address[0], "ws")
                    if not admit:
                        self._shed(admit)
                        return
                    # the session must not hold an in-flight REQUEST slot
                    # for its whole lifetime — subscriber count has its
                    # own cap (ws_register, checked before the 101)
                    server.admission.request_done()
                    self._serve_websocket()
                    return
                if parsed.path == "/metrics":
                    # Prometheus text exposition 0.0.4: real
                    # scrapers point here. The flat JSON form of the same
                    # gauges stays on the `metrics` JSON-RPC method (POST
                    # / websocket), which this GET path now shadows.
                    self._serve_prometheus()
                    return
                if parsed.path == "/health":
                    # liveness verdict (node/health.py): 200
                    # for ok/degraded, 503 for failing — probes key off
                    # the status code, the body is machine-readable
                    self._serve_health()
                    return
                if parsed.path.startswith("/debug/"):
                    # live wedge-triage surface: the flight
                    # ring, all-thread stacks, and queue depths — the
                    # three reads an operator needs against a node
                    # that stopped answering anything clever
                    self._serve_debug(parsed.path[len("/debug/"):])
                    return
                method = parsed.path.strip("/")
                if not method:
                    self._respond({"routes": sorted(server.routes)})
                    return
                admit = server.admission.admit_request(
                    self.client_address[0], self._request_kind(method))
                if not admit:
                    self._shed(admit)
                    return
                params = {}
                for k, v in parse_qsl(parsed.query):
                    try:
                        params[k] = json.loads(v)
                    except ValueError:
                        params[k] = v
                try:
                    self._rpc_result("", self._call(method, params))
                except RPCError as exc:
                    self._rpc_error("", str(exc), status=400)
                except Exception as exc:  # noqa: BLE001
                    server.logger.exception("rpc error")
                    self._rpc_error("", f"{type(exc).__name__}: {exc}")
                finally:
                    server.admission.request_done()

            def _serve_prometheus(self):
                from tendermint_tpu_torch.libs import telemetry

                node = getattr(server.ctx, "node", None)
                reg = getattr(node, "telemetry", None)
                if reg is None:
                    # context without a node (mock harnesses): serve the
                    # process-wide instruments rather than 404ing the
                    # scrape target
                    reg = telemetry.default_registry()
                try:
                    body = reg.render_prometheus().encode()
                except Exception:  # noqa: BLE001 — a scrape must never
                    # take the RPC thread down with it
                    server.logger.exception("prometheus render failed")
                    self.send_error(500, "metrics render failed")
                    return
                self.send_response(200)
                self.send_header("Content-Type", telemetry.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _serve_health(self):
                node = getattr(server.ctx, "node", None)
                if node is None:
                    # context without a node (mock harnesses): answer the
                    # probe rather than 404 the endpoint contract
                    self._respond({"status": "ok", "code": 0, "checks": {},
                                   "note": "no node in RPC context"})
                    return
                # a node-like facade (replica daemon) supplies its own
                # verdict through health_fn; full nodes use health_report
                health_fn = getattr(node, "health_fn", None)
                if health_fn is None:
                    from tendermint_tpu_torch.node.health import health_report

                    health_fn = lambda: health_report(node)  # noqa: E731
                try:
                    report = health_fn()
                except Exception:  # noqa: BLE001 — a broken check is a
                    # wiring bug; surface it as a probe failure, never
                    # take the RPC thread down
                    server.logger.exception("health render failed")
                    self.send_error(500, "health render failed")
                    return
                self._respond(
                    report, status=503 if report["status"] == "failing"
                    else 200,
                )

            # -- debug introspection ----------------------------

            def _serve_debug(self, what: str):
                """GET /debug/{flight,stacks,queues}. Every read is
                best-effort against live objects — a subsystem mid-
                teardown costs its section, never the endpoint (this is
                the surface for nodes that are already wedged)."""
                from tendermint_tpu_torch.rpc.core.debug import debug_payload

                node = getattr(server.ctx, "node", None)
                try:
                    payload = debug_payload(what, node)
                except KeyError:
                    self.send_error(
                        404, "unknown debug endpoint (flight|stacks|queues)"
                    )
                    return
                except Exception:  # noqa: BLE001 — triage must not take
                    # the RPC thread down
                    server.logger.exception("debug render failed")
                    self.send_error(500, "debug render failed")
                    return
                self._respond(payload)

            # -- websocket -------------------------------------------------

            def _serve_websocket(self):
                key = self.headers.get("Sec-WebSocket-Key")
                if not key:
                    self.send_error(400, "not a websocket upgrade")
                    return
                conn = WSConnection(server, self.connection)
                if not server.admission.ws_register(conn):
                    # subscriber budget exhausted: typed 503 instead of
                    # the 101 (counted under rpc_shed_total{ws_cap})
                    self._shed(adm.Admit(False, 503, adm.SHED_WS_CAP, 1.0))
                    return
                sndbuf = server.admission.ws_sndbuf()
                if sndbuf:
                    # bounded kernel send buffer: a slow consumer's
                    # backlog lands in the accounted send queue instead
                    # of hiding in multi-MB socket buffers
                    try:
                        self.connection.setsockopt(
                            socket.SOL_SOCKET, socket.SO_SNDBUF, sndbuf)
                    except OSError:
                        pass
                accept = base64.b64encode(
                    hashlib.sha1((key + _WS_MAGIC).encode()).digest()
                ).decode()
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header("Sec-WebSocket-Accept", accept)
                self.end_headers()
                conn.run()
                self.close_connection = True

        if is_unix_laddr(laddr):
            path = laddr.split("://", 1)[-1]
            self._httpd = _UnixThreadingHTTPServer(path, Handler)
            self.port = 0
            self.unix_path: str | None = path
        else:
            host, _, port = laddr.split("://", 1)[-1].rpartition(":")
            self._httpd = ThreadingHTTPServer((host or "0.0.0.0", int(port)), Handler)
            self.port = self._httpd.server_address[1]
            self.unix_path = None
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    def on_start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="rpc.httpd"
        )
        self._thread.start()
        if self.unix_path:
            self.logger.info("RPC server listening on unix://%s", self.unix_path)
        else:
            self.logger.info("RPC server listening on port %d", self.port)

    def on_stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self.unix_path:
            import os as _os

            try:
                _os.unlink(self.unix_path)
            except FileNotFoundError:
                pass


class WSConnection:
    """One WebSocket session: JSON-RPC calls + event subscriptions
    (handlers.go:351-630).

    Fan-out backpressure: outbound JSON rides a BOUNDED
    per-client queue drained by this client's own writer thread, so the
    event bus never blocks on a subscriber socket. Queue overflow drops
    the oldest N messages (counted); a subscriber that keeps
    overflowing is evicted (`ws_evictions_total`). Teardown is
    idempotent and runs on EVERY exit path — reader error, writer error,
    close frame, eviction — so a dead client can never leave a callback
    on the event delivery path."""

    def __init__(self, server: RPCServer, sock: socket.socket):
        self.server = server
        self.sock = sock
        self._wmtx = threading.Lock()
        self._listener_id = f"ws-{id(self):x}"
        self._subscribed: set[str] = set()
        self._closed = False
        self._sendq: deque = deque()
        self._q_cv = threading.Condition(threading.Lock())
        self._overflows = 0
        self._torn = False

    # -- frame IO (RFC 6455, server side: no masking on send) --------------

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("ws closed")
            buf += chunk
        return bytes(buf)

    def _read_frame(self) -> tuple[int, bytes]:
        b1, b2 = self._read_exact(2)
        opcode = b1 & 0x0F
        masked = b2 & 0x80
        length = b2 & 0x7F
        if length == 126:
            (length,) = struct.unpack(">H", self._read_exact(2))
        elif length == 127:
            (length,) = struct.unpack(">Q", self._read_exact(8))
        mask = self._read_exact(4) if masked else b""
        payload = self._read_exact(length)
        if mask:
            payload = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
        return opcode, payload

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        head = bytearray([0x80 | opcode])
        n = len(payload)
        if n < 126:
            head.append(n)
        elif n < 1 << 16:
            head.append(126)
            head += struct.pack(">H", n)
        else:
            head.append(127)
            head += struct.pack(">Q", n)
        with self._wmtx:
            self.sock.sendall(bytes(head) + payload)

    def sendq_depth(self) -> int:
        with self._q_cv:
            return len(self._sendq)

    def send_json(self, obj) -> None:
        """Enqueue for this client's writer thread — the event-bus side
        of the session NEVER touches the socket, so one slow consumer
        cannot stall event delivery to anyone else."""
        if self._closed:
            return
        admission = self.server.admission
        qmax = admission.ws_send_queue()
        evict = False
        with self._q_cv:
            if self._torn:
                return
            if qmax and len(self._sendq) >= qmax:
                # drop-oldest N: the subscriber keeps the freshest
                # events; repeated overflow means it can't keep up at
                # all — evict rather than serve a permanently-lagged view
                drop = min(max(1, qmax // 4), len(self._sendq))
                for _ in range(drop):
                    self._sendq.popleft()
                self._overflows += 1
                admission.ws_dropped(drop)
                if self._overflows >= admission.ws_max_overflows():
                    evict = True
            if not evict:
                self._sendq.append(obj)
                self._q_cv.notify()
        if evict:
            admission.ws_evicted()
            self._teardown()

    def _writer_loop(self) -> None:
        try:
            while True:
                with self._q_cv:
                    while not self._sendq and not self._closed:
                        self._q_cv.wait(0.5)
                    if self._closed:
                        return
                    obj = self._sendq.popleft()
                self._send_frame(0x1, _dumps(obj))
        except (ConnectionError, OSError):
            pass
        finally:
            self._teardown()

    def _teardown(self) -> None:
        """Idempotent session teardown: deregister event callbacks,
        leave the subscriber registry, close the socket (which unblocks
        the reader), wake the writer. Safe from any thread."""
        with self._q_cv:
            if self._torn:
                return
            self._torn = True
            self._closed = True
            self._q_cv.notify_all()
        evsw = getattr(self.server.ctx, "event_switch", None)
        if evsw is not None:
            try:
                evsw.remove_listener(self._listener_id)
            except Exception:  # noqa: BLE001 — teardown must finish
                self.server.logger.exception("ws listener removal failed")
        self.server.admission.ws_unregister(self)
        try:
            self.sock.close()
        except OSError:
            pass

    # -- session loop ------------------------------------------------------

    def run(self) -> None:
        writer = threading.Thread(
            target=self._writer_loop, daemon=True, name="rpc.ws.writer"
        )
        writer.start()
        try:
            while not self._closed:
                opcode, payload = self._read_frame()
                if opcode == 0x8:  # close
                    self._send_frame(0x8, b"")
                    return
                if opcode == 0x9:  # ping
                    self._send_frame(0xA, payload)
                    continue
                if opcode not in (0x1, 0x2):
                    continue
                self._handle(payload)
        except (ConnectionError, OSError):
            pass
        finally:
            self._teardown()
            writer.join(timeout=2.0)

    def _handle(self, payload: bytes) -> None:
        id_ = None
        try:
            req = json.loads(payload.decode())
            id_ = req.get("id")
            method = req.get("method", "")
            params = req.get("params") or {}
            if method == "subscribe":
                self._subscribe(params["event"])
                result = {}
            elif method == "unsubscribe":
                self._unsubscribe(params["event"])
                result = {}
            else:
                route = self.server.routes.get(method)
                if route is None:
                    raise RPCError(f"unknown RPC method {method!r}")
                fn, known = route
                if isinstance(params, list):
                    params = dict(zip(known, params))
                result = fn(self.server.ctx, **_coerce_params(params, known))
            self.send_json({"jsonrpc": "2.0", "id": id_, "result": result, "error": ""})
        except Exception as exc:  # noqa: BLE001
            self.send_json(
                {"jsonrpc": "2.0", "id": id_, "result": None, "error": f"{exc}"}
            )

    def _subscribe(self, event: str) -> None:
        admission = self.server.admission
        if (admission.pressure_fn is not None
                and admission.pressure_fn() >= adm.PRESSURE_SHED_READS):
            # ladder rung 1: new subscriptions shed with the reads
            admission.shed(adm.SHED_READS)
            raise RPCError(f"shed:{adm.SHED_READS}")
        evsw = self.server.ctx.event_switch
        if evsw is None:
            raise RPCError("no event switch")
        if event in self._subscribed:
            return
        self._subscribed.add(event)

        def on_event(data, event=event):
            self.send_json(
                {
                    "jsonrpc": "2.0",
                    "id": "",
                    "result": {"event": event, "data": data},
                    "error": "",
                }
            )

        evsw.add_listener_for_event(self._listener_id, event, on_event)

    def _unsubscribe(self, event: str) -> None:
        evsw = self.server.ctx.event_switch
        if evsw is None:
            return
        self._subscribed.discard(event)
        evsw.remove_listener_for_event(event, self._listener_id)
