"""The port's RPC (tendermint_tpu_torch/rpc/) against the JAX package's.

tests/test_rpc_transports.py's 14 cases run on the port: the transport
matrix — echo calls over HTTP(TCP), HTTP(unix socket), URI-GET, and
WebSocket on both listeners (reference: rpc/lib/rpc_test.go:40-75 runs the
same echo handler over HTTP, WS and unix transports; server side
rpc/lib/server/http_server.go:20-40) — with every unix socket under a
short `mkdtemp(prefix="tmd", dir="/tmp")` (AF_UNIX's 108-byte cap). Beside
them: tests/test_nat_profiler.py's TestProfilerRoutes (the unsafe
profiler routes in rpc/core/handlers), and the two packages' RPCServers
over equal stores (a DevChain of each with a kv tx index) answering
status, block, commit, validators, tx and abci_query with proofs in equal
JSON bodies."""

from __future__ import annotations

import json
import os
import tempfile
import urllib.error
import urllib.request

import pytest

from tendermint_tpu_torch.rpc.client import HTTPClient, WSClient, _UnixHTTPConnection
from tendermint_tpu_torch.rpc.server import RPCServer, is_unix_laddr


def _echo(ctx, value=None):
    return {"value": value}


class _Ctx:
    event_switch = None


def _make_server(laddr: str) -> RPCServer:
    srv = RPCServer(laddr, _Ctx())
    # the framework test exercises transports, not the core route table:
    # swap in the reference test's echo handler (rpc_test.go:24-38)
    srv.routes = {"echo": (_echo, ["value"])}
    srv.start()
    return srv


@pytest.fixture(scope="module")
def tcp_server():
    srv = _make_server("127.0.0.1:0")
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def unix_server():
    path = os.path.join(tempfile.mkdtemp(prefix="tmd", dir="/tmp"), "rpc.sock")
    srv = _make_server(f"unix://{path}")
    yield srv
    srv.stop()


def test_is_unix_laddr():
    assert is_unix_laddr("unix:///tmp/x.sock")
    assert is_unix_laddr("/tmp/x.sock")
    assert not is_unix_laddr("tcp://0.0.0.0:46657".split("://", 1)[-1])
    assert not is_unix_laddr("127.0.0.1:0")


def test_http_echo_over_tcp(tcp_server):
    c = HTTPClient(f"127.0.0.1:{tcp_server.port}")
    assert c.echo(value="hello")["value"] == "hello"


def test_http_echo_over_unix(unix_server):
    c = HTTPClient(f"unix://{unix_server.unix_path}")
    assert c.echo(value="hello-unix")["value"] == "hello-unix"
    # round-trip non-ASCII and structured params like the reference's
    # random-string echo loop (rpc_test.go:118-130)
    assert c.echo(value=["a", 1, {"b": None}])["value"] == ["a", 1, {"b": None}]


def test_uri_get_over_tcp(tcp_server):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{tcp_server.port}/echo?value=%22x%22"
    ) as resp:
        body = json.loads(resp.read().decode())
    assert body["result"]["value"] == "x"


def test_uri_get_over_unix(unix_server):
    conn = _UnixHTTPConnection(unix_server.unix_path, timeout=10.0)
    try:
        conn.request("GET", '/echo?value="y"')
        body = json.loads(conn.getresponse().read().decode())
    finally:
        conn.close()
    assert body["result"]["value"] == "y"


def test_ws_echo_over_tcp(tcp_server):
    ws = WSClient(f"127.0.0.1:{tcp_server.port}")
    try:
        assert ws.call("echo", value="ws")["value"] == "ws"
    finally:
        ws.close()


def test_ws_echo_over_unix(unix_server):
    ws = WSClient(f"unix://{unix_server.unix_path}")
    try:
        assert ws.call("echo", value="ws-unix")["value"] == "ws-unix"
    finally:
        ws.close()


def test_tcp_scheme_accepted():
    """The documented \"tcp://host:port\" form must construct (the scheme
    is stripped), matching the unix:// branch's behavior."""
    srv = _make_server("tcp://127.0.0.1:0")
    try:
        c = HTTPClient(f"127.0.0.1:{srv.port}")
        assert c.echo(value=1)["value"] == 1
    finally:
        srv.stop()


def test_http_client_keepalive_reuses_connection(tcp_server):
    """The replica's upstream fetch path must NOT
    pay a TCP handshake per request — one thread keeps one connection."""
    c = HTTPClient(f"127.0.0.1:{tcp_server.port}")
    assert c.echo(value=1)["value"] == 1
    conn1 = c._local.conn
    assert conn1 is not None
    assert c.echo(value=2)["value"] == 2
    assert c._local.conn is conn1
    assert c.reconnects == 0
    c.close()
    assert c._local.conn is None


def test_http_client_reconnects_on_eof(tcp_server):
    """Regression: EOF on the persistent connection (server restart,
    idle timeout) heals with ONE transparent rebuild + resend."""
    c = HTTPClient(f"127.0.0.1:{tcp_server.port}")
    assert c.echo(value="a")["value"] == "a"
    # sever the kept-alive connection out from under the client — what
    # the far end going away looks like to the next request
    c._local.conn.sock.close()
    assert c.echo(value="b")["value"] == "b"
    assert c.reconnects == 1
    # healed connection persists again
    assert c.echo(value="c")["value"] == "c"
    assert c.reconnects == 1
    c.close()


def test_http_client_fresh_connection_failure_raises():
    """A server that is genuinely down raises to the caller — the
    retry-once path is only for connections that died while parked."""
    srv = _make_server("127.0.0.1:0")
    port = srv.port
    srv.stop()
    c = HTTPClient(f"127.0.0.1:{port}")
    with pytest.raises(OSError):
        c.echo(value=1)
    assert c.reconnects == 0


def test_http_client_keepalive_over_unix(unix_server):
    c = HTTPClient(f"unix://{unix_server.unix_path}")
    assert c.echo(value="u1")["value"] == "u1"
    conn1 = c._local.conn
    assert conn1 is not None
    assert c.echo(value="u2")["value"] == "u2"
    assert c._local.conn is conn1
    c.close()


def test_unix_bind_refuses_to_delete_regular_file():
    """A mistyped laddr pointing at an existing regular file must fail at
    bind WITHOUT deleting the file."""
    path = os.path.join(tempfile.mkdtemp(prefix="tmd", dir="/tmp"), "precious.txt")
    with open(path, "w") as f:
        f.write("do not delete")
    with pytest.raises(OSError):
        RPCServer(f"unix://{path}", _Ctx())
    assert open(path).read() == "do not delete"


def test_unix_socket_removed_on_stop():
    path = os.path.join(tempfile.mkdtemp(prefix="tmd", dir="/tmp"), "gone.sock")
    srv = _make_server(f"unix://{path}")
    assert os.path.exists(path)
    srv.stop()
    assert not os.path.exists(path)


# -- tests/test_nat_profiler.py's TestProfilerRoutes, on the port -------------


class TestProfilerRoutes:
    def test_cpu_and_heap_profile(self, tmp_path):
        from tendermint_tpu_torch.rpc.core import handlers

        cpu_out = tmp_path / "cpu.prof"
        heap_out = tmp_path / "heap.txt"
        handlers.unsafe_start_cpu_profiler(None, str(cpu_out))
        with pytest.raises(handlers.RPCError):
            handlers.unsafe_start_cpu_profiler(None, str(cpu_out))  # already on
        sum(i * i for i in range(10000))  # some work to profile
        res = handlers.unsafe_stop_cpu_profiler(None)
        assert "profile written" in res["log"]
        assert cpu_out.stat().st_size > 0
        import pstats

        pstats.Stats(str(cpu_out))  # parses as a valid profile
        with pytest.raises(handlers.RPCError):
            handlers.unsafe_stop_cpu_profiler(None)  # already off
        handlers.unsafe_write_heap_profile(None, str(heap_out))
        # second call captures live tracing
        handlers.unsafe_write_heap_profile(None, str(heap_out))
        assert heap_out.exists()

    def test_routes_registered_as_unsafe(self):
        from tendermint_tpu_torch.rpc.core.handlers import UNSAFE_ROUTES_TABLE

        for r in (
            "unsafe_start_cpu_profiler",
            "unsafe_stop_cpu_profiler",
            "unsafe_write_heap_profile",
        ):
            assert r in UNSAFE_ROUTES_TABLE


# -- the two packages' RPCServers over equal stores ----------------------------


def _node_server(root: str):
    """Package `root`'s RPCServer on 127.0.0.1 over a 6-block KVStore
    DevChain (the seeded validator, so both packages build the same chain)
    whose state indexes its txs: the store, the state, the app's query
    connection and the genesis doc in an RPCContext."""
    import importlib
    import threading

    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    app = m("abci.apps.kvstore").KVStoreApp()
    chain = m("statesync.devchain").DevChain(app)
    chain.state.tx_indexer = m("state.txindex").KVTxIndexer(m("libs.db").MemDB())
    chain.build(6, tx_fn=lambda h: [b"k%d-%d=v%d" % (h, i, h) for i in range(3)])
    query = m("proxy.app_conn").AppConnQuery(m("abci.client").LocalClient(app, threading.RLock()))
    ctx = m("rpc.core").RPCContext(
        block_store=chain.block_store, proxy_app_query=query, genesis_doc=chain.genesis_doc,
        state=chain.state, tx_indexer=chain.state.tx_indexer,
    )
    srv = m("rpc.server").RPCServer("127.0.0.1:0", ctx)
    srv.start()
    return srv


def _post(port: int, method: str, params: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/",
        data=json.dumps({"jsonrpc": "2.0", "id": 7, "method": method, "params": params}).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as exc:  # an RPC error: its body, with its status
        return {"status": exc.code, **json.loads(exc.read())}


def test_rpc_bodies_equal_jax():
    """The same calls to the port's and the JAX package's RPCServer over
    equal chains return equal JSON bodies: status, a block, a canonical
    and the head's seen commit, a historical validator set, a tx with its
    inclusion proof, and abci_query with a state-tree proof for a present
    and an absent key (and the errors of a height past the head)."""
    from tendermint_tpu_torch.types.tx import tx_hash

    calls = [
        ("status", {}), ("block", {"height": 3}), ("commit", {"height": 3}), ("commit", {"height": 6}),
        ("validators", {"height": 2}), ("tx", {"hash": tx_hash(b"k4-1=v4").hex(), "prove": True}),
        ("abci_query", {"data": b"k4-1".hex(), "height": 5, "prove": True}),
        ("abci_query", {"data": b"absent".hex(), "height": 5, "prove": True}),
        ("abci_query", {"data": b"k2-0".hex()}), ("block", {"height": 9}),
    ]
    servers = [_node_server("tendermint_tpu_torch"), _node_server("tendermint_tpu")]
    try:
        port, jax = ([_post(srv.port, meth, params) for meth, params in calls] for srv in servers)
        port, jax = list(port), list(jax)
    finally:
        for srv in servers:
            srv.stop()
    assert port == jax
    assert [bool(b["error"]) for b in port] == [False] * 9 + [True]
    assert port[5]["result"]["proof"]["root_hash"]
    assert port[6]["result"]["response"]["value"] == b"v4".hex().upper()
    assert port[7]["result"]["response"]["log"] == "does not exist"
