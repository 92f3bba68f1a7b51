"""The port's node behind gRPC: the BroadcastAPI (ref rpc/grpc/api.go:14) of
a running port node, and a port node whose app sits behind the ABCI gRPC
transport (ref proxy/client.go:40-58). The port's copy of
tests/test_grpc.py's `TestBroadcastAPI` and
`test_node_commits_blocks_over_grpc_abci`; the ABCI gRPC pair itself is
held against the JAX package's in tests/test_torch_abci.py. Each node runs
on the CPU defaults of tests/test_torch_node_rpc.py's `host_defaults`."""

from __future__ import annotations

import tempfile
import time

import pytest

pytest.importorskip("grpc")

from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp
from tendermint_tpu_torch.abci.grpc import GRPCServer
from tendermint_tpu_torch.config import reset_test_root
from tendermint_tpu_torch.node import default_new_node
from tests.test_torch_node_rpc import host_defaults  # noqa: F401 — module-scoped CPU defaults


def wait_until(cond, timeout=30.0, tick=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


class TestBroadcastAPI:
    @pytest.fixture(scope="class")
    def node(self, host_defaults):  # noqa: F811
        tmp = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
        cfg = reset_test_root(tmp)
        cfg.base.proxy_app = "kvstore"
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        cfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
        cfg.p2p.laddr = "tcp://127.0.0.1:0"
        n = default_new_node(cfg)
        n.start()
        assert wait_until(lambda: n.block_store.height() >= 1, timeout=30)
        yield n
        n.stop()

    def test_ping_and_broadcast_tx(self, node):
        from tendermint_tpu_torch.rpc.grpc import GRPCBroadcastClient

        c = GRPCBroadcastClient(node.grpc_server.addr)
        try:
            assert c.ping() == {}
            res = c.broadcast_tx(b"gk=gv")
            assert res["check_tx"]["code"] == 0
            assert res["deliver_tx"]["code"] == 0
            assert res["height"] > 0
        finally:
            c.close()


def test_node_commits_blocks_over_grpc_abci(host_defaults):  # noqa: F811
    """The `abci: grpc` config path end-to-end: a real node drives its
    app through the gRPC transport for all three connections and still
    makes blocks (proxy/client.go:40-58)."""
    app = KVStoreApp()
    server = GRPCServer(app, "127.0.0.1:0")
    server.start()
    tmp = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
    cfg = reset_test_root(tmp)
    cfg.base.proxy_app = server.addr
    cfg.base.abci = "grpc"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    n = default_new_node(cfg)
    n.start()
    try:
        assert wait_until(lambda: n.block_store.height() >= 2, timeout=30)
        n.mempool.check_tx(b"gx=gy")
        assert wait_until(lambda: app.query(b"gx").value == b"gy", timeout=30)
    finally:
        n.stop()
        server.stop()
