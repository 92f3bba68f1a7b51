"""The port daemon's streamed planes (verify_stream, hash_stream) and
their transport behaviours, as the JAX package's test_devd_stream.py and
test_devd_hash_stream.py hold its daemon to them: parity with the
single-shot ops and the JAX package's functions, a malformed mid-stream
frame answered with an error frame while the daemon keeps serving,
reconnect after a restart, the status counters, and the gateway's stream
floor. Transport cases ride the sim daemon (no torch, instant start);
parity rides the port daemon on the CPU. Daemons as in test_torch_devd.
"""

from __future__ import annotations

import os
import shutil
import socket
import struct
import sys
import tempfile
import threading
import time

import pytest

from test_torch_devd import CPU_DAEMON_S, SIM_DAEMON_S, DevdProc, signed_items
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto.hashing import ripemd160 as jripemd160
from tendermint_tpu.merkle import simple as jsimple
from tendermint_tpu.ops.gateway import _cpu_verify_batch as j_cpu_verify_batch
from tendermint_tpu_torch import devd
from tendermint_tpu_torch.ops import devd_backend, gateway

SIM = {"TENDERMINT_DEVD_SIM_RATE": "100000"}


@pytest.fixture(scope="module")
def cpu_daemon():
    d = DevdProc()
    try:
        d.wait_held(CPU_DAEMON_S)
        yield d
    finally:
        d.stop()


@pytest.fixture
def sim_daemon():
    d = DevdProc(env=SIM)
    try:
        d.wait_held(SIM_DAEMON_S)
        yield d
    finally:
        d.stop()


def _sim_items(n: int, tag: bytes = b"sim"):
    return [(b"\x05" * 32, tag + b"-%d" % i, b"\x06" * 64) for i in range(n)]


def test_chunk_width_from_the_claim_time_bake_off(cpu_daemon):
    """With TENDERMINT_DEVD_CHUNK unset the daemon tunes the width at claim
    (the warm set's widest shape here) and advertises it; a client
    frames at it."""
    rep = devd.DevdClient(cpu_daemon.sock).ping()
    assert rep["stream_chunk"] == 16
    assert "stream chunk width: 16" in cpu_daemon.log_tail(20000)
    assert devd.DevdClient(cpu_daemon.sock).stream_chunk() == 16


@pytest.mark.parametrize("width", [4, 9])
def test_streamed_parity_with_single_shot_and_cpu(cpu_daemon, width):
    """Lane for lane: streamed == single-shot == the JAX package's CPU
    verify, over valid, forged, tampered, empty-message and long-message
    lanes; a remainder chunk and one exact chunk."""
    items = [it for it in signed_items(10, tag=b"par") if len(it[0]) == 32]
    seed = bytes([33, 0]) + b"\x21" * 30
    long = b"L" * 300
    items.append((jed.public_key(seed), long, jed.sign(seed, long)))
    want = j_cpu_verify_batch(items)
    c = devd.DevdClient(cpu_daemon.sock)
    try:
        assert c.verify_stream(items, chunk=width) == want
        stream = c.status()["stream"]
        assert stream["chunks"] >= -(-len(items) // width) and stream["errors"] == 0
        assert c.stream_stats()["stream_lanes"] == len(items)
    finally:
        c.close()


def test_hash_stream_parity_and_counters(cpu_daemon):
    items = [bytes([i % 251]) * (i * 977 % 3000) for i in range(11)]
    c = devd.DevdClient(cpu_daemon.sock)
    try:
        assert c.hash_stream(items, mode="part", chunk=4) == [jripemd160(x) for x in items]
        digests, nodes = c.hash_stream(items, mode="part", tree=True, chunk=5)
        assert nodes == jsimple.flat_tree_from_leaf_digests(digests).internal_nodes()
        assert c.hash_stream([], mode="part", tree=True) == ([], [])
        hs = c.status()["hash_stream"]
        assert hs["trees"] >= 1 and hs["lanes"] >= 2 * len(items) and hs["errors"] == 0
        assert c.hash_stream_stats()["stream_trees"] == 1
    finally:
        c.close()


def test_daemon_overlaps_chunks_in_flight(sim_daemon):
    c = devd.DevdClient(sim_daemon.sock)
    try:
        assert all(c.verify_stream(_sim_items(4000), chunk=200))
        stream = c.status()["stream"]
        assert stream["inflight_max"] >= 2 and stream["inflight"] == 0
        assert stream["chunks"] == 20 and stream["lanes"] == 4000
    finally:
        c.close()


@pytest.mark.parametrize("op", ["verify_stream", "hash_stream"])
def test_malformed_mid_stream_frame_gets_error_frame(sim_daemon, op):
    """One good chunk, then garbage: the good chunk is answered, the bad
    one gets an error frame (never a hang), the stream closes, and the
    daemon keeps serving new connections."""
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(10.0)
    conn.connect(sim_daemon.sock)
    try:
        devd._send_frame(conn, {"op": op, "chunks": 3, "total": 8, "mode": "part"})
        if op == "verify_stream":
            good = devd._pack_chunk(_sim_items(4, b"mal"))
        else:
            good = devd._pack_hash_chunk([b"a", b"bb", b"ccc"])
        conn.sendall(struct.pack(">I", len(good)) + good)
        garbage = b"\xde\xad\xbe\xef" * 5  # claims 0xefbeadde lanes
        conn.sendall(struct.pack(">I", len(garbage)) + garbage)
        status, idx = struct.unpack_from("<BI", devd._recv_raw_frame(conn), 0)
        assert (status, idx) == (devd.STREAM_OK, 0)
        second = devd._recv_raw_frame(conn)
        assert struct.unpack_from("<BI", second, 0) == (devd.STREAM_ERR, 1)
        assert b"malformed" in second[5:]
        conn.settimeout(5.0)
        assert conn.recv(1) == b""
    finally:
        conn.close()
    c = devd.DevdClient(sim_daemon.sock)
    try:
        key = "stream" if op == "verify_stream" else "hash_stream"
        deadline = time.monotonic() + 5.0
        while c.status()[key]["errors"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert c.status()[key]["errors"] == 1
        assert all(c.verify_stream(_sim_items(6, b"after"), chunk=4))
    finally:
        c.close()


def test_bad_lane_fails_fast_without_hanging(sim_daemon):
    c = devd.DevdClient(sim_daemon.sock, io_timeout=10.0)
    items = _sim_items(6)
    items[3] = (b"\x05" * 33, items[3][1], items[3][2])
    try:
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="stream lane 3"):
            c.verify_stream(items, chunk=4)
        assert time.monotonic() - t0 < 10.0
        assert c.ping()["held"]
    finally:
        c.close()


def test_reconnect_after_restart():
    """A pooled connection to a daemon that restarted is stale: the client
    retries the whole request once on a fresh one, and counts it."""
    first = DevdProc(env=SIM)
    sock = first.sock
    second = None
    c = devd.DevdClient(sock)
    try:
        first.wait_held(SIM_DAEMON_S)
        assert all(c.verify_batch(_sim_items(3)))
        assert all(c.verify_stream(_sim_items(8), chunk=4))
        first.kill()
        second = DevdProc(env=SIM, sock=sock)
        second.wait_held(SIM_DAEMON_S)
        assert all(c.verify_batch(_sim_items(3, b"again")))
        assert c.hash_batch([b"x"]) == [jripemd160(b"x")]
        assert c.stream_stats()["reconnects"] >= 1
    finally:
        c.close()
        if second is not None:
            second.stop()
        first.stop()


def test_gateway_rides_the_stream_at_its_floor(sim_daemon, monkeypatch):
    """devd_backend streams at or above TENDERMINT_DEVD_STREAM_MIN lanes
    and goes single-shot below; the gateway's stats fold in the client's
    stream counters."""
    monkeypatch.setenv("TENDERMINT_DEVD_SOCK", sim_daemon.sock)
    monkeypatch.setenv("TENDERMINT_DEVD_STREAM_MIN", "8")
    monkeypatch.setenv("TENDERMINT_DEVD_CHUNK", "16")
    monkeypatch.delenv("TENDERMINT_TPU_KERNEL", raising=False)
    monkeypatch.setattr(devd_backend, "_client", None)
    devd.bust_avail_cache()
    gateway.reset_devd_breaker()
    try:
        v = gateway.Verifier(min_tpu_batch=1)
        assert v.kernel == "devd"
        assert all(v.verify_batch(_sim_items(5)))  # single shot
        assert all(v.verify_batch(_sim_items(40)))  # 3 chunks of 16
        stats = v.stats()
        assert stats["stream_batches"] == 1 and stats["stream_chunks_out"] == 3
        assert stats["stream_lanes"] == 40 and stats["tpu_sigs"] == 45
        done = []
        v.prime_cache_async(_sim_items(12, b"prime"), on_done=done.append)
        assert v.verify_one(*_sim_items(12, b"prime")[4]) is True
    finally:
        if devd_backend._client is not None:
            devd_backend._client.close()
        monkeypatch.setattr(devd_backend, "_client", None)
        devd.bust_avail_cache()
        gateway.reset_devd_breaker()


def test_old_daemon_latches_single_shot(monkeypatch):
    """A daemon that answers a stream header with a pickled refusal (an
    older build) latches the single-shot path, and the breaker's on_close
    re-arms it."""
    monkeypatch.setattr(devd_backend, "_stream_ok", True)

    class OldClient:
        def verify_stream(self, items, chunk=None):
            raise devd.DevdError("daemon too old for verify_stream")

        def verify_batch(self, items):
            return [True] * len(items)

    monkeypatch.setattr(devd_backend, "_client", OldClient())
    monkeypatch.setenv("TENDERMINT_DEVD_STREAM_MIN", "2")
    assert list(devd_backend.verify_batch(_sim_items(4))) == [True] * 4
    assert devd_backend._stream_ok is False
    gateway._breaker_on_close(devd.sock_path())
    assert devd_backend._stream_ok is True


def test_daemon_counters_hold_under_a_client_storm(monkeypatch):
    """More client threads than cores against one sim daemon served in
    this process, with a short switch interval: every request is answered
    right and the daemon's counters, updated from its handler threads,
    lose no update."""
    d = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
    sock = os.path.join(d, "s")
    monkeypatch.setenv("TENDERMINT_DEVD_SIM_RATE", "10000000")
    monkeypatch.setenv("TENDERMINT_DEVD_ACCEPT_CPU", "1")
    monkeypatch.setenv("TENDERMINT_DEVD_EXIT_ON_TERM", "1")
    server = threading.Thread(target=devd.serve, args=(sock,), daemon=True)
    interval = sys.getswitchinterval()
    workers, rounds = 2 * (os.cpu_count() or 4), 6
    errors: list = []

    def run(k: int) -> None:
        c = devd.DevdClient(sock, io_timeout=30.0)
        try:
            for r in range(rounds):
                assert c.verify_batch(_sim_items(3, b"s%d-%d" % (k, r))) == [True] * 3
                assert all(c.verify_stream(_sim_items(10, b"t%d-%d" % (k, r)), chunk=4))
                leaves = [b"%d-%d-%d" % (k, r, i) for i in range(5)]
                assert c.hash_stream(leaves, mode="part", chunk=2) == [jripemd160(x) for x in leaves]
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)
        finally:
            c.close()

    try:
        sys.setswitchinterval(1e-6)
        server.start()
        deadline = time.monotonic() + 30.0
        while not os.path.exists(sock) and time.monotonic() < deadline:
            time.sleep(0.01)
        threads = [threading.Thread(target=run, args=(k,)) for k in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        status = devd.DevdClient(sock).status()
        assert status["stats"]["tpu_sigs"] == workers * rounds * 13
        assert status["stream"]["lanes"] == workers * rounds * 10
        assert status["stream"]["chunks"] == workers * rounds * 3 and status["stream"]["inflight"] == 0
        assert status["hash_stream"]["lanes"] == workers * rounds * 5
        assert status["hash_stream"]["chunks"] == workers * rounds * 3
    finally:
        sys.setswitchinterval(interval)
        if os.path.exists(sock):
            devd.DevdClient(sock, connect_timeout=1.0, io_timeout=5.0).shutdown()
        server.join(timeout=15)
        assert not server.is_alive()
        shutil.rmtree(d, ignore_errors=True)
