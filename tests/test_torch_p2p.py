"""The port's transport (p2p/, libs/flowrate.py, version.py) against the
JAX package's.

The cases of tests/test_p2p.py run on the port's modules (the two on
the gossip reactors' channel ceilings, then the address book and PEX
cases, at the end), and so do the flowrate and PeerSet cases of tests/test_libs_wire.py. Beside them: MConnection packets and NodeInfo
bytes equal to the JAX package's for the same messages, an MConnection
of each package on the two ends of one stream, and a port Switch and a
JAX Switch peered over TCP with secret connections, either side dialing,
exchanging NodeInfo and echo messages on a shared channel.
"""

from __future__ import annotations

import socket as _socket
import struct as _struct
import threading
import time

import numpy as np
import pytest

from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
from tendermint_tpu_torch.p2p import (
    ChannelDescriptor,
    MConnection,
    NetAddress,
    NodeInfo,
    Reactor,
    Switch,
    connect2_switches,
    make_connected_switches,
)
from tendermint_tpu_torch.p2p.addrbook import AddrBook
from tendermint_tpu_torch.p2p.node_info import default_version
from tendermint_tpu_torch.p2p.secret_connection import SecretConnection
from tendermint_tpu_torch.p2p.stream import pipe_pair


def wait_until(cond, timeout=5.0, tick=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


def _secret_pair(a, b, ka=None, kb=None):
    out = {}
    t = threading.Thread(target=lambda: out.update(conn=SecretConnection(b, kb or gen_priv_key_ed25519())),
                         daemon=True)
    t.start()
    ca = SecretConnection(a, ka or gen_priv_key_ed25519())
    t.join(5)
    return ca, out["conn"]


# -- netaddress ---------------------------------------------------------------


def test_netaddress_parse_and_classify():
    a = NetAddress.from_string("127.0.0.1:26656")
    assert a.ip == "127.0.0.1" and a.port == 26656
    assert a.valid() and a.local() and not a.routable()
    assert NetAddress("8.8.8.8", 53).routable()
    assert not NetAddress("10.0.0.1", 80).routable()
    assert not NetAddress("notanip", 80).valid()
    with pytest.raises(ValueError):
        NetAddress.from_string("nocolon")
    assert NetAddress("8.8.8.8", 53).same_network(NetAddress("8.8.4.4", 99))


# -- secret connection --------------------------------------------------------


def test_secret_connection_roundtrip():
    a, b = pipe_pair()
    ka, kb = gen_priv_key_ed25519(), gen_priv_key_ed25519()
    ca, cb = _secret_pair(a, b, ka, kb)
    assert ca.remote_pubkey().raw == kb.pub_key().raw
    assert cb.remote_pubkey().raw == ka.pub_key().raw
    payload = bytes(range(256)) * 20
    ca.write(payload)
    got = bytearray()
    while len(got) < len(payload):
        got += cb.read(4096)
    assert bytes(got) == payload
    cb.write(b"pong")
    assert ca.read(10) == b"pong"
    ca.close()


def test_secret_connection_tampering_detected():
    from tendermint_tpu_torch.p2p.secret_connection import SecretConnectionError

    a, b = pipe_pair()
    ca, cb = _secret_pair(a, b)
    ca.stream.write(b"\x00\x20" + b"\x00" * 32)
    with pytest.raises(SecretConnectionError):
        cb.read(10)
    with pytest.raises(SecretConnectionError):
        cb.read(1)
    ca.close()


# -- mconnection --------------------------------------------------------------


def _mconn_pair(descs=None, **cfg_kw):
    from tendermint_tpu_torch.p2p.conn import MConnConfig

    descs = descs or [ChannelDescriptor(id=0x01, priority=1)]
    a, b = pipe_pair()
    recv_a, recv_b, err = [], [], []
    ma = MConnection(a, descs, lambda ch, m: recv_a.append((ch, m)), lambda e: err.append(e), MConnConfig(**cfg_kw))
    mb = MConnection(b, descs, lambda ch, m: recv_b.append((ch, m)), lambda e: err.append(e), MConnConfig(**cfg_kw))
    ma.start()
    mb.start()
    return ma, mb, recv_a, recv_b, err


def test_mconnection_send_recv_multipacket():
    ma, mb, recv_a, recv_b, _ = _mconn_pair()
    msg = b"x" * 5000
    assert ma.send(0x01, msg)
    assert wait_until(lambda: recv_b and recv_b[0] == (0x01, msg))
    assert mb.send(0x01, b"reply")
    assert wait_until(lambda: recv_a and recv_a[0] == (0x01, b"reply"))
    ma.stop()
    mb.stop()


def test_mconnection_unknown_channel_refused():
    ma, mb, *_ = _mconn_pair()
    assert not ma.send(0x99, b"nope")
    assert not ma.try_send(0x99, b"nope")
    ma.stop()
    mb.stop()


def test_mconnection_ping_pong_keeps_alive():
    ma, mb, _, recv_b, err = _mconn_pair(ping_interval=0.05, pong_timeout=1.0)
    time.sleep(0.4)
    assert not err
    assert ma.send(0x01, b"still here")
    assert wait_until(lambda: recv_b)
    ma.stop()
    mb.stop()


def test_mconnection_peer_close_fires_on_error():
    ma, mb, _, _, err = _mconn_pair()
    mb.stream.close()
    assert wait_until(lambda: err)
    ma.stop()
    mb.stop()


def test_mconnection_priority_fairness():
    descs = [ChannelDescriptor(id=0x01, priority=1, send_queue_capacity=100),
             ChannelDescriptor(id=0x02, priority=10, send_queue_capacity=100)]
    ma, mb, _, recv_b, _ = _mconn_pair(descs)
    for _ in range(50):
        ma.try_send(0x01, b"bulk" * 256)
    ma.try_send(0x02, b"urgent")
    assert wait_until(lambda: any(ch == 0x02 for ch, _ in recv_b), timeout=10)
    ma.stop()
    mb.stop()


def test_mconnection_long_message_skips_the_flush_throttle():
    """A message of several bursts (64 packets a wakeup) goes out back to
    back, as connection.go's send routine signals itself again while
    packets remain: 300 packets at a 2 s flush throttle arrive before the
    first throttle wait would have ended."""
    ma, mb, _, recv_b, _ = _mconn_pair(flush_throttle=2.0)
    msg = bytes(range(256)) * 1200
    t0 = time.monotonic()
    assert ma.send(0x01, msg)
    assert wait_until(lambda: recv_b, timeout=10.0)
    assert time.monotonic() - t0 < 2.0
    assert recv_b == [(0x01, msg)]
    ma.stop()
    mb.stop()


def test_mconnection_writes_a_burst_at_once():
    """The packets of one wakeup reach the stream in one write, as
    connection.go's buffered writer hands them on, so a secret connection
    under it seals full frames rather than two a packet."""
    from tendermint_tpu_torch.p2p.conn import MConnConfig

    descs = [ChannelDescriptor(id=0x01, priority=1)]
    a, b = pipe_pair()
    writes = []
    write = a.write

    def counted(data):
        writes.append(len(data))
        return write(data)

    a.write = counted
    recv_b = []
    ma = MConnection(a, descs, lambda ch, m: None, lambda e: None, MConnConfig())
    mb = MConnection(b, descs, lambda ch, m: recv_b.append((ch, m)), lambda e: None, MConnConfig())
    ma.start()
    mb.start()
    msg = b"z" * (10 * 1024)
    assert ma.send(0x01, msg)
    assert wait_until(lambda: recv_b)
    assert recv_b == [(0x01, msg)]
    assert writes == [10 * (5 + 1024)]
    ma.stop()
    mb.stop()


# -- switch -------------------------------------------------------------------


class EchoReactor(Reactor):
    """Records messages."""

    def __init__(self, ch_id=0x05):
        self.ch_id = ch_id
        self.received = []
        self.peers = []

    def start(self):
        pass

    def stop(self):
        pass

    def get_channels(self):
        return [ChannelDescriptor(id=self.ch_id, priority=1, send_queue_capacity=32)]

    def add_peer(self, peer):
        self.peers.append(peer)

    def remove_peer(self, peer, reason):
        if peer in self.peers:
            self.peers.remove(peer)

    def receive(self, ch_id, peer, msg):
        self.received.append((peer.id(), msg))


def _make_net(n):
    reactors = []

    def init(i, sw):
        r = EchoReactor()
        reactors.append(r)
        sw.add_reactor("echo", r)
        return sw

    return make_connected_switches(n, init), reactors


def test_switch_broadcast_reaches_all_peers():
    sws, reactors = _make_net(3)
    try:
        sws[0].broadcast(0x05, b"fan-out")
        assert wait_until(lambda: len(reactors[1].received) == 1)
        assert wait_until(lambda: len(reactors[2].received) == 1)
        assert reactors[1].received[0][1] == b"fan-out"
    finally:
        for sw in sws:
            sw.stop()


def test_switch_refuses_self_and_duplicate_connections():
    sws, _ = _make_net(2)
    try:
        with pytest.raises(ConnectionError):
            connect2_switches(sws, 0, 1)
    finally:
        for sw in sws:
            sw.stop()


def test_switch_incompatible_network_rejected():
    sw_a, sw_b = Switch(), Switch()
    sw_a.add_reactor("echo", EchoReactor())
    sw_b.add_reactor("echo", EchoReactor())
    for sw, net in ((sw_a, "chain-A"), (sw_b, "chain-B")):
        sw.set_node_info(NodeInfo(pub_key=sw.node_priv_key.pub_key(), moniker="m", network=net,
                                  version=default_version("0.1.0")))
        sw.start()
    try:
        with pytest.raises(ConnectionError, match="network mismatch"):
            connect2_switches([sw_a, sw_b], 0, 1)
        assert sw_a.peers.size() == 0 and sw_b.peers.size() == 0
    finally:
        sw_a.stop()
        sw_b.stop()


def test_switch_stop_peer_for_error_removes_from_reactors():
    sws, reactors = _make_net(2)
    try:
        peer = sws[0].peers.list()[0]
        sws[0].stop_peer_for_error(peer, "test")
        assert sws[0].peers.size() == 0
        assert peer not in reactors[0].peers
        assert wait_until(lambda: sws[1].peers.size() == 0)
    finally:
        for sw in sws:
            sw.stop()


def test_switch_tcp_listener_end_to_end():
    from tendermint_tpu_torch.p2p.listener import Listener

    sw_a, sw_b = Switch(), Switch()
    ra, rb = EchoReactor(), EchoReactor()
    sw_a.add_reactor("echo", ra)
    sw_b.add_reactor("echo", rb)
    lst = Listener("127.0.0.1:0")
    sw_a.add_listener(lst)
    sw_a.start()
    sw_b.start()
    try:
        peer = sw_b.dial_peer_with_address(NetAddress("127.0.0.1", lst.internal_address().port))
        assert wait_until(lambda: sw_a.peers.size() == 1)
        peer.send(0x05, b"over tcp")
        assert wait_until(lambda: ra.received and ra.received[0][1] == b"over tcp")
    finally:
        sw_a.stop()
        sw_b.stop()


def test_listener_refuses_upnp_until_ported(monkeypatch):
    """Listener(skip_upnp=False) tries an IGD port mapping (p2p/upnp.py) and,
    where no gateway answers, listens unmapped: the external address is the
    bound one and stop() deletes no mapping. Discovery is pointed at a
    local UDP socket that never answers."""
    import functools

    from tendermint_tpu_torch.p2p import upnp
    from tendermint_tpu_torch.p2p.listener import Listener

    sink = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    monkeypatch.setattr(upnp, "discover", functools.partial(upnp.discover, ssdp_addr=sink.getsockname()))
    try:
        lst = Listener("127.0.0.1:0", skip_upnp=False)
        try:
            assert lst._upnp_nat is None
            assert lst.external_address() == lst.internal_address()
        finally:
            lst.stop()
    finally:
        sink.close()


def test_inbound_ip_range_count_released_on_peer_removal():
    from tendermint_tpu_torch.p2p.listener import Listener

    sw_a, sw_b = Switch(), Switch()
    sw_a.add_reactor("echo", EchoReactor())
    sw_b.add_reactor("echo", EchoReactor())
    lst = Listener("127.0.0.1:0")
    sw_a.add_listener(lst)
    sw_a.start()
    sw_b.start()
    try:
        port = lst.internal_address().port
        for _ in range(3):
            sw_b.dial_peer_with_address(NetAddress("127.0.0.1", port))
            assert wait_until(lambda: sw_a.peers.size() == 1)
            assert sw_a.ip_ranges.count("127") == 1
            sw_a.stop_peer_for_error(sw_a.peers.list()[0], "churn")
            assert wait_until(lambda: sw_b.peers.size() == 0)
            assert wait_until(lambda: sw_a.ip_ranges.count("127") == 0)
    finally:
        sw_a.stop()
        sw_b.stop()


# -- fuzz ---------------------------------------------------------------------


def test_fuzzed_stream_delays_but_delivers():
    from tendermint_tpu_torch.p2p.fuzz import FuzzedStream

    a, b = pipe_pair()
    fa = FuzzedStream(a, prob_sleep=0.5, max_delay=0.01, seed=7)
    fa.write(b"through the fuzz")
    assert b.read(100) == b"through the fuzz"
    fa.close()


def test_switch_inbound_peer_cap():
    from tendermint_tpu_torch.config.config import P2PConfig

    sw = Switch(config=P2PConfig(max_num_peers=1))

    class _FakePeer:
        def id(self):
            return "aa" * 20

        def key(self):
            return self.id()

    assert sw.peers.add(_FakePeer())
    a, b = _socket.socketpair()
    try:
        sw._accept_peer(a)
        b.settimeout(2)
        assert b.recv(1) == b""
    finally:
        for s in (a, b):
            try:
                s.close()
            except OSError:
                pass


def test_switch_ip_range_cap():
    from tendermint_tpu_torch.p2p.ip_range_counter import IPRangeCounter

    sw = Switch()
    sw.ip_ranges = IPRangeCounter(limits=(1, 1, 1))
    assert sw.ip_ranges.try_add("127.0.0.1")
    lst = _socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    cli = _socket.create_connection(lst.getsockname())
    srv, _ = lst.accept()
    try:
        sw._accept_peer(srv)
        cli.settimeout(2)
        assert cli.recv(1) == b""
    finally:
        for s in (cli, srv, lst):
            try:
                s.close()
            except OSError:
                pass


def test_recv_routine_never_inherits_the_admission_timeout():
    """A quiet link past the switch's admission timeout must not read as
    EOF once the peer has started (Peer.on_start clears the raw socket's
    timeout before the recv routine launches)."""
    from tendermint_tpu_torch.p2p.peer import Peer, PeerConfig
    from tendermint_tpu_torch.p2p.stream import SocketStream

    a, b = _socket.socketpair()
    a.settimeout(0.4)
    got, errs = [], []
    peer = Peer(SocketStream(a), outbound=False, channel_descs=[ChannelDescriptor(id=0x20)],
                on_receive=lambda p, ch, msg: got.append((ch, msg)), on_error=lambda p, exc: errs.append(exc),
                config=PeerConfig(auth_enc=False), node_priv_key=gen_priv_key_ed25519())
    peer.start()
    time.sleep(0.05)
    a.settimeout(None)
    try:
        time.sleep(1.0)
        payload = b"hello-after-quiet"
        b.sendall(_struct.pack(">BBBH", 0x02, 0x20, 1, len(payload)) + payload)
        assert wait_until(lambda: got, timeout=5), f"message lost; connection errors: {errs}"
        assert got[0] == (0x20, payload)
        assert not errs, f"connection fataled on a healthy quiet link: {errs}"
    finally:
        peer.stop()
        b.close()


def test_node_info_dribble_hits_absolute_deadline():
    from tendermint_tpu_torch.p2p.peer import exchange_node_info
    from tendermint_tpu_torch.p2p.stream import SocketStream

    a, b = _socket.socketpair()
    info = NodeInfo(pub_key=gen_priv_key_ed25519().pub_key(), moniker="m", network="n",
                    version=default_version("t"))
    stop = threading.Event()

    def dribble():
        try:
            b.recv(65536)
            b.sendall(_struct.pack(">I", 512))
            while not stop.is_set():
                b.sendall(b"x")
                stop.wait(0.15)
        except OSError:
            pass

    threading.Thread(target=dribble, daemon=True).start()
    t0 = time.monotonic()
    try:
        with pytest.raises(ConnectionError, match="timed out"):
            exchange_node_info(SocketStream(a), info, timeout=0.8)
        assert time.monotonic() - t0 < 5.0
    finally:
        stop.set()
        for s in (a, b):
            try:
                s.close()
            except OSError:
                pass


def test_secretconn_oversized_frame_claim_refused_before_buffering():
    from tendermint_tpu_torch.libs import telemetry
    from tendermint_tpu_torch.p2p.secret_connection import DATA_MAX_SIZE, SecretConnectionError

    a, b = pipe_pair()
    ca, cb = _secret_pair(a, b)
    reg = telemetry.default_registry()
    over0 = reg.counter("p2p_secretconn_oversized_frames_total").value
    ca.stream.write(_struct.pack(">H", DATA_MAX_SIZE + 17))
    with pytest.raises(SecretConnectionError, match="oversized"):
        cb.read(10)
    with pytest.raises(SecretConnectionError):
        cb.read(1)
    assert reg.counter("p2p_secretconn_oversized_frames_total").value == over0 + 1
    ca.close()


def test_channel_reassembly_past_ceiling_drops_peer():
    """Streaming a message past a channel's receive ceiling (the
    blockchain channel's, here) errors the connection instead of
    buffering it; nothing is delivered."""
    from tendermint_tpu_torch.blockchain.reactor import BLOCKCHAIN_CHANNEL

    descs = [ChannelDescriptor(id=BLOCKCHAIN_CHANNEL, recv_message_capacity=1 << 16)]
    ma, mb, recv_a, recv_b, err = _mconn_pair(descs=descs)
    try:
        assert ma.send(BLOCKCHAIN_CHANNEL, b"\x00" * (1 << 17))
        assert wait_until(lambda: err, timeout=5), "oversize never errored"
        assert any("exceeds" in str(e) for e in err), err
        assert not recv_b
    finally:
        ma.stop()
        mb.stop()


def test_fuzzed_stream_corrupts_deterministically():
    from tendermint_tpu_torch.p2p.fuzz import FuzzedStream

    outs = []
    for _ in range(2):
        a, b = pipe_pair()
        fa = FuzzedStream(a, prob_corrupt=1.0, seed=3)
        fa.write(b"AAAABBBB")
        got = b.read(100)
        outs.append(got)
        assert got != b"AAAABBBB" and len(got) == 8
        assert sum(x != y for x, y in zip(got, b"AAAABBBB")) == 1
        assert fa.corrupted_writes == 1
        fa.close()
        b.close()
    assert outs[0] == outs[1]
    a, b = pipe_pair()
    with pytest.raises(TypeError):
        FuzzedStream(a, prob_drop_rw=0.5)
    a.close()
    b.close()


def test_fuzz_corruption_is_loud_tamper_under_secretconn():
    from tendermint_tpu_torch.libs import telemetry
    from tendermint_tpu_torch.p2p.fuzz import FuzzedStream
    from tendermint_tpu_torch.p2p.secret_connection import SecretConnectionError

    a, b = pipe_pair()
    fa = FuzzedStream(a, prob_corrupt=0.0, seed=5)
    ca, cb = _secret_pair(fa, b)
    reg = telemetry.default_registry()
    af0 = reg.counter("p2p_secretconn_auth_failures_total").value
    fa.prob_corrupt = 1.0
    ca.write(b"this frame will not verify")
    with pytest.raises(SecretConnectionError):
        cb.read(10)
    assert fa.corrupted_writes >= 1
    assert reg.counter("p2p_secretconn_auth_failures_total").value > af0
    ca.close()


def test_ip_range_counter_boundary_and_churn_races():
    from tendermint_tpu_torch.p2p.ip_range_counter import IPRangeCounter

    c = IPRangeCounter(limits=(2, 2, 2))
    assert c.try_add("9.9.9.1") and c.try_add("9.9.9.2")
    assert not c.try_add("9.9.9.3")
    c.remove("9.9.9.1")
    assert c.try_add("9.9.9.3")
    assert not c.try_add("9.9.9.4")
    assert c.count("9") == 2 and c.count("9.9") == 2 and c.count("9.9.9") == 2

    c2 = IPRangeCounter(limits=(64, 32, 16))
    errs = []

    def churn(tid):
        try:
            for i in range(300):
                ip = f"10.0.{tid % 3}.{i % 7}"
                if c2.try_add(ip):
                    c2.remove(ip)
        except Exception as exc:  # noqa: BLE001
            errs.append(exc)

    threads = [threading.Thread(target=churn, args=(t,), daemon=True) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errs
    for p in ("10", "10.0", "10.0.0", "10.0.1", "10.0.2"):
        assert c2.count(p) == 0, (p, c2.count(p))


def test_uncount_stream_releases_exactly_once_across_wrapper_chain():
    from tendermint_tpu_torch.p2p.fuzz import FuzzedStream
    from tendermint_tpu_torch.p2p.stream import SocketStream

    sw = Switch()
    assert sw.ip_ranges.try_add("10.1.2.3")
    assert sw.ip_ranges.try_add("10.1.2.4")
    s1, s2 = _socket.socketpair()
    raw = SocketStream(s1)
    raw.counted_ip = "10.1.2.3"

    class _Outer:
        def __init__(self, stream):
            self.stream = stream

    chain = _Outer(FuzzedStream(raw))
    sw._uncount_stream(chain)
    assert sw.ip_ranges.count("10.1.2") == 1
    sw._uncount_stream(chain)
    assert sw.ip_ranges.count("10.1.2") == 1
    for s in (s1, s2):
        s.close()


def test_reconnect_policy_reads_the_jax_knobs(monkeypatch):
    from tendermint_tpu.p2p import switch as jswitch
    from tendermint_tpu_torch.p2p import switch as pswitch

    assert pswitch._reconnect_policy() == jswitch._reconnect_policy()
    monkeypatch.setenv("TENDERMINT_P2P_RECONNECT_ATTEMPTS", "7")
    monkeypatch.setenv("TENDERMINT_P2P_RECONNECT_INTERVAL_S", "0.25")
    assert pswitch._reconnect_policy() == jswitch._reconnect_policy() == (7, 0.25)


# -- libs/flowrate and p2p/peer_set -------------------------------------------


class TestFlowrate:
    def test_status_tracks_totals_and_avg(self):
        from tendermint_tpu_torch.libs.flowrate import Monitor

        m = Monitor(sample_period=0.01)
        for _ in range(10):
            m.update(1000)
            time.sleep(0.002)
        st = m.status()
        assert st.bytes == 10_000 and st.avg_rate > 0
        m.update(1000)
        assert m.status().bytes == 11_000

    def test_limit_paces_average_rate(self):
        from tendermint_tpu_torch.libs.flowrate import Monitor

        m = Monitor()
        t0 = time.monotonic()
        sent = 0
        while sent < 3000:
            n = m.limit(1000, rate_limit=10_000)
            m.update(n)
            sent += n
        assert time.monotonic() - t0 >= 0.15
        assert m.limit(500, rate_limit=0) == 500


class _P:
    def __init__(self, pid):
        self._pid = pid

    def id(self):
        return self._pid


class TestPeerSet:
    def test_add_get_remove(self):
        from tendermint_tpu_torch.p2p.peer_set import PeerSet

        ps = PeerSet()
        a, b = _P("aa"), _P("bb")
        assert ps.add(a) and ps.add(b)
        assert not ps.add(_P("aa"))
        assert ps.has("aa") and ps.get("bb") is b
        assert ps.size() == 2 and {p.id() for p in ps.list()} == {"aa", "bb"}
        ps.remove(a)
        assert not ps.has("aa") and ps.size() == 1
        ps.remove(a)

    def test_cap_enforced_under_concurrent_adds(self):
        from tendermint_tpu_torch.p2p.peer_set import PeerSet

        ps = PeerSet()
        admitted = []
        barrier = threading.Barrier(32)

        def dial(i):
            barrier.wait()
            if ps.add(_P("p%02d" % i), cap=8):
                admitted.append(i)

        threads = [threading.Thread(target=dial, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(admitted) == 8 and ps.size() == 8


# -- the same bytes as the JAX package ----------------------------------------


def test_version_constants_equal():
    from tendermint_tpu import version as jv
    from tendermint_tpu_torch import version as pv

    assert (pv.VERSION, pv.PROTOCOL_VERSION, pv.__version__) == (jv.VERSION, jv.PROTOCOL_VERSION, jv.__version__)


def _packets(conn_mod, descs, msgs):
    """Every packet frame an MConnection channel cuts from `msgs`, in order."""
    ch = conn_mod._Channel(descs, conn_mod.MConnConfig())
    for m in msgs:
        assert ch.try_send_bytes(m) or ch.send_bytes(m, 1.0)
    out = []
    while (frame := ch.next_packet()) is not None:
        out.append(frame)
    return out


def test_mconnection_packets_equal_jax():
    from tendermint_tpu.p2p import conn as jconn
    from tendermint_tpu_torch.p2p import conn as pconn

    rng = np.random.default_rng(21)
    msgs = [b"", b"x", rng.bytes(1023), rng.bytes(1024), rng.bytes(1025), rng.bytes(5000)]
    pdesc = pconn.ChannelDescriptor(id=0x40, priority=5, send_queue_capacity=len(msgs))
    jdesc = jconn.ChannelDescriptor(id=0x40, priority=5, send_queue_capacity=len(msgs))
    got = _packets(pconn, pdesc, msgs)
    assert got == _packets(jconn, jdesc, msgs)
    assert len(got) == 1 + 1 + 1 + 1 + 2 + 5
    assert (pconn.PACKET_TYPE_PING, pconn.PACKET_TYPE_MSG, pconn.PACKET_TYPE_PONG,
            pconn.MAX_MSG_PACKET_PAYLOAD_SIZE) == (jconn.PACKET_TYPE_PING, jconn.PACKET_TYPE_MSG,
                                                   jconn.PACKET_TYPE_PONG, jconn.MAX_MSG_PACKET_PAYLOAD_SIZE)
    assert pconn.MConnConfig().__dict__ == jconn.MConnConfig().__dict__


@pytest.mark.parametrize("other", ["", "commit_schedule=full>aggregate@21"])
def test_node_info_bytes_equal_jax(other):
    from tendermint_tpu.crypto.keys import PubKeyEd25519 as JPub
    from tendermint_tpu.p2p.node_info import NodeInfo as JNodeInfo
    from tendermint_tpu.p2p.node_info import default_version as jdefault_version

    pub = gen_priv_key_ed25519(b"node-info").pub_key()
    fields = dict(moniker="n0", network="chain", remote_addr="127.0.0.1:1", listen_addr="127.0.0.1:2",
                  channels=bytes([0x20, 0x40]), other=[other] if other else [])
    mine = NodeInfo(pub_key=pub, version=default_version("0.1.0"), **fields)
    theirs = JNodeInfo(pub_key=JPub(pub.raw), version=jdefault_version("0.1.0"), **fields)
    assert mine.encode() == theirs.encode()
    assert NodeInfo.decode(theirs.encode()).encode() == JNodeInfo.decode(mine.encode()).encode()
    assert mine.id() == theirs.id()


def test_mconnection_interoperates_with_jax():
    """A port MConnection on one end of a stream and a JAX one on the
    other: multi-packet messages on two channels cross both ways."""
    from tendermint_tpu.p2p import conn as jconn
    from tendermint_tpu.p2p.stream import SocketStream as JStream
    from tendermint_tpu_torch.p2p.conn import MConnConfig
    from tendermint_tpu_torch.p2p.stream import SocketStream

    s1, s2 = _socket.socketpair()
    descs = [ChannelDescriptor(id=0x20, priority=5), ChannelDescriptor(id=0x40, priority=1)]
    jdescs = [jconn.ChannelDescriptor(id=0x20, priority=5), jconn.ChannelDescriptor(id=0x40, priority=1)]
    recv_p, recv_j, err = [], [], []
    mp = MConnection(SocketStream(s1), descs, lambda ch, m: recv_p.append((ch, m)), err.append,
                     MConnConfig(ping_interval=0.05))
    mj = jconn.MConnection(JStream(s2), jdescs, lambda ch, m: recv_j.append((ch, m)), err.append,
                           jconn.MConnConfig(ping_interval=0.05))
    mp.start()
    mj.start()
    try:
        rng = np.random.default_rng(22)
        msgs = [(0x20, rng.bytes(10)), (0x40, rng.bytes(5000)), (0x20, rng.bytes(1024))]
        for ch, m in msgs:
            assert mp.send(ch, m) and mj.send(ch, m[::-1])
        assert wait_until(lambda: len(recv_j) == 3 and len(recv_p) == 3, timeout=10)
        assert sorted(recv_j) == sorted(msgs)
        assert sorted(recv_p) == sorted((ch, m[::-1]) for ch, m in msgs)
        time.sleep(0.2)  # a few ping/pong rounds across the packages
        assert not err, err
    finally:
        mp.stop()
        mj.stop()


def _jax_switch(moniker: str, network: str):
    from tendermint_tpu.p2p import ChannelDescriptor as JDesc
    from tendermint_tpu.p2p import NodeInfo as JNodeInfo
    from tendermint_tpu.p2p import Reactor as JReactor
    from tendermint_tpu.p2p import Switch as JSwitch
    from tendermint_tpu.p2p.node_info import default_version as jdefault_version

    class JEcho(JReactor):
        def __init__(self):
            self.received = []

        def start(self):
            pass

        def stop(self):
            pass

        def get_channels(self):
            return [JDesc(id=0x05, priority=1, send_queue_capacity=32)]

        def add_peer(self, peer):
            pass

        def remove_peer(self, peer, reason):
            pass

        def receive(self, ch_id, peer, msg):
            self.received.append((peer.id(), msg))
            peer.try_send(ch_id, b"echo:" + msg)

    sw = JSwitch()
    r = sw.add_reactor("echo", JEcho())
    sw.set_node_info(JNodeInfo(pub_key=sw.node_priv_key.pub_key(), moniker=moniker, network=network,
                               version=jdefault_version("0.1.0")))
    return sw, r


@pytest.mark.parametrize("port_dials", [True, False], ids=["port-dials-jax", "jax-dials-port"])
def test_switches_peer_across_packages_over_tcp(port_dials):
    """A port Switch and a JAX Switch on 127.0.0.1, secret connections on:
    the dialed side listens, the handshake exchanges NodeInfo (each side
    holds the other's), and echo messages cross on the shared channel."""
    from tendermint_tpu.p2p import NetAddress as JNetAddress
    from tendermint_tpu.p2p.listener import Listener as JListener
    from tendermint_tpu_torch.p2p.listener import Listener

    sw_p = Switch()
    rp = sw_p.add_reactor("echo", EchoReactor())
    sw_p.set_node_info(NodeInfo(pub_key=sw_p.node_priv_key.pub_key(), moniker="port", network="cross",
                                version=default_version("0.1.0")))
    sw_j, rj = _jax_switch("jax", "cross")
    if port_dials:
        lst = JListener("127.0.0.1:0")
        sw_j.add_listener(lst)
    else:
        lst = Listener("127.0.0.1:0")
        sw_p.add_listener(lst)
    sw_p.start()
    sw_j.start()
    try:
        port = lst.internal_address().port
        if port_dials:
            sw_p.dial_peer_with_address(NetAddress("127.0.0.1", port))
        else:
            sw_j.dial_peer_with_address(JNetAddress("127.0.0.1", port))
        assert wait_until(lambda: sw_p.peers.size() == 1 and sw_j.peers.size() == 1, timeout=10)
        (pp,), (jp,) = sw_p.peers.list(), sw_j.peers.list()
        assert pp.node_info.encode() == sw_j.node_info.encode()
        assert jp.node_info.encode() == sw_p.node_info.encode()
        assert pp.stream.remote_pubkey().raw == sw_j.node_priv_key.pub_key().raw
        assert pp.outbound == port_dials and jp.outbound != port_dials
        for i in range(3):
            assert pp.send(0x05, b"hello-%d" % i)
        assert wait_until(lambda: len(rp.received) == 3, timeout=10)
        assert [m for _, m in rj.received] == [b"hello-%d" % i for i in range(3)]
        assert [m for _, m in rp.received] == [b"echo:hello-%d" % i for i in range(3)]
        assert {pid for pid, _ in rp.received} == {pp.id()}
    finally:
        sw_p.stop()
        sw_j.stop()


# -- the gossip reactors' channels ----------------------------------------------


def test_reactor_recv_ceilings_right_sized():
    """The per-channel reassembly ceilings are right-sized to each
    channel's largest legal message, equal to the JAX package's: every
    channel inheriting the 21 MiB block ceiling would let an
    oversized-frame peer park ~147 MiB of never-delivered reassembly
    bytes across one connection's channels."""
    from tendermint_tpu.consensus.reactor import ConsensusReactor as JConsensusReactor
    from tendermint_tpu.mempool.reactor import MempoolReactor as JMempoolReactor
    from tendermint_tpu_torch.codec import jsonval as jv
    from tendermint_tpu_torch.consensus.reactor import (
        DATA_CHANNEL,
        STATE_CHANNEL,
        VOTE_CHANNEL,
        VOTE_SET_BITS_CHANNEL,
        ConsensusReactor,
    )
    from tendermint_tpu.p2p.pex import PEXReactor as JPEXReactor
    from tendermint_tpu_torch.mempool.reactor import MempoolReactor
    from tendermint_tpu_torch.p2p.pex import PEXReactor
    from tendermint_tpu_torch.types.params import MAX_BLOCK_PART_SIZE_BYTES

    caps = {
        d.id: d.recv_message_capacity
        for d in ConsensusReactor.get_channels(None)
    }
    assert caps[VOTE_CHANNEL] == 1 << 16  # a vote is ~700 B
    assert caps[STATE_CHANNEL] == 1 << 16
    assert caps[VOTE_SET_BITS_CHANNEL] == 1 << 16
    # the DATA cap derives from the params-validated part-size bound
    assert caps[DATA_CHANNEL] == 2 * MAX_BLOCK_PART_SIZE_BYTES + (1 << 16)
    assert caps[DATA_CHANNEL] < 1 << 20
    [mp] = MempoolReactor.get_channels(None)
    # ... but a MAX_TX_BYTES tx must still fit (hex-doubled + envelope)
    assert mp.recv_message_capacity >= 2 * jv.MAX_TX_BYTES
    assert mp.recv_message_capacity < 10 * (1 << 20)
    [px] = PEXReactor.get_channels(None)
    assert px.recv_message_capacity == 1 << 16

    def fields(descs):
        return [(d.id, d.priority, d.send_queue_capacity, d.recv_buffer_capacity, d.recv_message_capacity)
                for d in descs]

    assert fields(ConsensusReactor.get_channels(None)) == fields(JConsensusReactor.get_channels(None))
    assert fields(MempoolReactor.get_channels(None)) == fields(JMempoolReactor.get_channels(None))
    assert fields(PEXReactor.get_channels(None)) == fields(JPEXReactor.get_channels(None))
    # ... and genesis validation refuses a part size the channel could
    # not carry (the binding that keeps cap and params consistent)
    from tendermint_tpu_torch.types.params import ConsensusParams

    cp = ConsensusParams()
    cp.block_gossip.block_part_size_bytes = MAX_BLOCK_PART_SIZE_BYTES + 1
    err = cp.validate()
    assert err is not None and "recv ceiling" in err
    cp.block_gossip.block_part_size_bytes = MAX_BLOCK_PART_SIZE_BYTES
    assert cp.validate() is None


def test_vote_channel_reassembly_past_ceiling_drops_peer():
    """Streaming a message past the vote channel's 64 KiB bound errors the
    connection (the switch then drops the peer for cause) instead of
    buffering toward the old 21 MiB."""
    from tendermint_tpu_torch.consensus.reactor import VOTE_CHANNEL, ConsensusReactor

    descs = ConsensusReactor.get_channels(None)
    ma, mb, recv_a, recv_b, err = _mconn_pair(descs=descs)
    try:
        assert ma.send(VOTE_CHANNEL, b"\x00" * (1 << 17))  # 128 KiB
        assert wait_until(lambda: err, timeout=5), "oversize never errored"
        assert any("exceeds" in str(e) for e in err), err
        assert not recv_b, "oversized message must never be delivered"
    finally:
        ma.stop()
        mb.stop()


# -- the address book and PEX (tests/test_p2p.py's cases) ---------------------


def test_addrbook_add_pick_good(tmp_path):
    book = AddrBook(str(tmp_path / "addrbook.json"))
    src = NetAddress("1.2.3.4", 26656)
    for i in range(50):
        assert book.add_address(NetAddress(f"5.6.{i}.1", 26656), src) or True
    assert book.size() > 0
    picked = book.pick_address()
    assert picked is not None
    book.mark_good(picked)
    # non-routable rejected in strict mode
    assert not book.add_address(NetAddress("192.168.1.1", 26656), src)
    book.save()

    book2 = AddrBook(str(tmp_path / "addrbook.json"))
    assert book2.size() == book.size()
    assert any(str(picked) == str(ka.addr) and ka.is_old()
               for ka in book2._addrs.values())


def test_addrbook_selection_and_removal():
    book = AddrBook("", routability_strict=False)
    src = NetAddress("127.0.0.1", 1)
    for i in range(20):
        book.add_address(NetAddress("127.0.0.1", 1000 + i), src)
    sel = book.get_selection()
    assert 0 < len(sel) <= 20
    victim = sel[0]
    book.remove_address(victim)
    assert str(victim) not in book._addrs


def test_pex_reactor_exchanges_addresses():
    from tendermint_tpu_torch.p2p.pex import PEXReactor

    books = [AddrBook("", routability_strict=False) for _ in range(2)]
    books[0].add_address(NetAddress("127.0.0.1", 7771), NetAddress("127.0.0.1", 1))

    def init(i, sw):
        sw.add_reactor("pex", PEXReactor(books[i], ensure_peers_period=3600))
        sw.set_node_info(
            NodeInfo(
                pub_key=sw.node_priv_key.pub_key(),
                moniker=f"n{i}",
                network="test",
                version=default_version("0.1.0"),
                listen_addr=f"127.0.0.1:{7000 + i}",
            )
        )
        return sw

    sws = make_connected_switches(2, init)
    try:
        # node1's inbound peer (node0... whichever side is inbound) requests
        # addrs; eventually node1 learns node0's known address
        assert wait_until(
            lambda: books[0].size() + books[1].size() >= 3, timeout=5
        )
    finally:
        for sw in sws:
            sw.stop()


def test_addrbook_is_bad_and_eviction():
    import time as _time

    from tendermint_tpu_torch.p2p import addrbook as ab

    book = AddrBook("", routability_strict=False)
    src = NetAddress("127.0.0.1", 1)
    addr = NetAddress("127.0.0.1", 2000)
    book.add_address(addr, src)
    ka = book._addrs[str(addr)]

    # fresh address: not bad
    assert not ka.is_bad()
    # repeated failures without a success -> bad (once past the
    # recent-attempt grace window)
    for _ in range(ab.MAX_FAILURES):
        book.mark_attempt(addr)
    assert not ka.is_bad()  # just tried: within RECENT_ATTEMPT grace
    ka.last_attempt -= ab.RECENT_ATTEMPT + 1
    assert ka.is_bad()
    # a success clears badness; old addresses are never bad
    book.mark_good(addr)
    assert ka.is_old() and not ka.is_bad()
    # staleness: not heard from in STALE_AFTER
    ka2 = ab.KnownAddress(NetAddress("127.0.0.1", 2001), src)
    ka2.added = _time.time() - ab.STALE_AFTER - 1
    assert ka2.is_bad()

    # mark_bad removes outright (ref MarkBad)
    book.mark_bad(addr)
    assert str(addr) not in book._addrs


def test_addrbook_pick_skips_bad():
    from tendermint_tpu_torch.p2p import addrbook as ab

    book = AddrBook("", routability_strict=False)
    src = NetAddress("127.0.0.1", 1)
    good = NetAddress("127.0.0.1", 3000)
    bad = NetAddress("127.0.0.1", 3001)
    book.add_address(good, src)
    book.add_address(bad, src)
    kb = book._addrs[str(bad)]
    kb.attempts = ab.MAX_FAILURES
    kb.last_attempt = 1.0  # long ago, never succeeded -> bad
    for _ in range(50):
        picked = book.pick_address(new_bias_pct=100)
        assert str(picked) == str(good)


def test_addrbook_need_more_addrs():
    from tendermint_tpu_torch.p2p import addrbook as ab

    book = AddrBook("", routability_strict=False)
    assert book.need_more_addrs()
    assert ab.NEED_ADDRESS_THRESHOLD == 1000


def test_addrbook_pick_recovers_when_all_bad():
    """After an outage burns attempts on every address, pick_address must
    fall back to retrying them, never strand the node."""
    from tendermint_tpu_torch.p2p import addrbook as ab

    book = AddrBook("", routability_strict=False)
    src = NetAddress("127.0.0.1", 1)
    for port in (4000, 4001):
        a = NetAddress("127.0.0.1", port)
        book.add_address(a, src)
        ka = book._addrs[str(a)]
        ka.attempts = ab.MAX_FAILURES
        ka.last_attempt = 1.0  # never succeeded, long ago -> is_bad
    assert book.pick_address() is not None


def test_pex_flood_eviction_requires_ip_match():
    """A flooder claiming a victim's listen_addr must not evict it from
    the book; only an address matching the socket IP is marked bad."""
    from tendermint_tpu_torch.p2p.pex import PEXReactor

    book = AddrBook("", routability_strict=False)
    victim = NetAddress("127.0.0.1", 5555)
    book.add_address(victim, victim)

    class FakeStream:
        @staticmethod
        def remote_addr():
            return "10.9.9.9:1234"  # attacker's real socket IP

    class FakePeer:
        node_info = type(
            "NI", (), {"listen_addr": "127.0.0.1:5555"}
        )()  # claims the victim's address
        stream = FakeStream()

        @staticmethod
        def id():
            return "attacker"

    class FakeSwitch:
        stopped = []

        def stop_peer_for_error(self, peer, reason):
            self.stopped.append((peer, reason))

    pex = PEXReactor(book, ensure_peers_period=3600)
    pex.switch = FakeSwitch()
    pex._msg_counts["attacker"] = [time.monotonic()] * 1001  # over limit
    pex.receive(0x00, FakePeer(), b"{}")
    assert str(victim) in book._addrs  # victim survives
    assert pex.switch.stopped  # flooder still disconnected


def test_addrbook_one_slash24_cannot_dominate_the_book():
    """Eclipse backing, addr-book level: hundreds of addresses from one
    /24 (one attacker subnet, one source) collapse into the few buckets
    their (group, source-group) hash allows, so they evict EACH OTHER —
    while a handful of diverse addresses stay present and pickable."""
    import random as _random

    book = AddrBook()
    book._rng = _random.Random(7)
    src = NetAddress("9.9.9.1", 26656)
    for i in range(500):
        book.add_address(NetAddress(f"9.9.9.{i % 250}", 10000 + i), src)
    diverse = []
    for i in range(20):
        a = NetAddress(f"{20 + i}.{i + 1}.0.1", 26656)
        diverse.append(a)
        book.add_address(a, a)

    doms = [k for k in book._addrs if k.startswith("9.9.9.")]
    # one (group, src-group) pair hashes to at most NEW_BUCKETS_PER_ADDRESS
    # buckets of BUCKET_SIZE — the 500 dials cannot occupy more
    from tendermint_tpu_torch.p2p.addrbook import (
        BUCKET_SIZE,
        NEW_BUCKETS_PER_ADDRESS,
    )

    assert len(doms) <= NEW_BUCKETS_PER_ADDRESS * BUCKET_SIZE, len(doms)
    # every diverse address survived the flood
    for a in diverse:
        assert str(a) in book._addrs
    # and the picker still reaches them (seeded: deterministic)
    picked_diverse = sum(
        1 for _ in range(300)
        if not str(book.pick_address()).startswith("9.9.9.")
    )
    assert picked_diverse >= 10, picked_diverse
