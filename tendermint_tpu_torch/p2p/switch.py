"""Switch: reactor registry + peer lifecycle (reference: p2p/switch.go).

Reactors register channel descriptors; the switch owns dialing, accepting,
handshakes, peer filters, broadcast, and persistent-peer reconnection
(switch.go:15-18, 409-438: 30 attempts x 3s). `make_connected_switches`
wires N switches over in-process pipes for deterministic multi-node tests
(switch.go:502-547).
"""

from __future__ import annotations

import socket
import threading
import time

from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519, gen_priv_key_ed25519
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.node_info import NodeInfo
from tendermint_tpu_torch.p2p.peer import Peer, PeerConfig
from tendermint_tpu_torch.p2p.peer_set import PeerSet
from tendermint_tpu_torch.p2p.stream import SocketStream, pipe_pair

RECONNECT_ATTEMPTS = 30
RECONNECT_INTERVAL = 3.0


def _reconnect_policy() -> tuple[int, float]:
    """(attempts, interval_s), env-tunable so chaos harnesses can run
    tight partition-heal cycles without monkeypatching module globals
    (read per reconnect routine — the knobs apply to live switches)."""
    from tendermint_tpu_torch.libs.envknob import env_number

    return (
        int(env_number("TENDERMINT_P2P_RECONNECT_ATTEMPTS", RECONNECT_ATTEMPTS, cast=int)),
        float(env_number("TENDERMINT_P2P_RECONNECT_INTERVAL_S", RECONNECT_INTERVAL)),
    )


class Reactor:
    """Interface (switch.go:20-28). Subclasses are BaseServices too."""

    def set_switch(self, sw: "Switch") -> None:
        self.switch = sw

    def get_channels(self) -> list[ChannelDescriptor]:
        raise NotImplementedError

    def add_peer(self, peer: Peer) -> None:
        pass

    def remove_peer(self, peer: Peer, reason) -> None:
        pass

    def receive(self, ch_id: int, peer: Peer, msg_bytes: bytes) -> None:
        pass


class Switch(BaseService):
    def __init__(
        self,
        config=None,
        peer_config: PeerConfig | None = None,
        node_priv_key: PrivKeyEd25519 | None = None,
    ):
        super().__init__(name="p2p.switch")
        self.config = config
        self.peer_config = peer_config or PeerConfig()
        self.reactors: dict[str, Reactor] = {}
        self.ch_descs: list[ChannelDescriptor] = []
        self.reactors_by_ch: dict[int, Reactor] = {}
        self.peers = PeerSet()
        self.dialing: set[str] = set()
        self.node_priv_key = node_priv_key or gen_priv_key_ed25519()
        self.node_info: NodeInfo | None = None
        # registry scoping the p2p_peer_* series: the node
        # sets this to its own registry (node/telemetry.build_registry)
        # so two in-process nodes keep separate per-peer counters; None
        # falls back to the process-wide default
        self.metrics_registry = None
        # black-box flight recorder (node/flightrec.py): the
        # node wires it so peer connect/drop land in the event ring;
        # None (bare switches) records nothing
        self.flightrec = None
        self.listeners: list = []
        self.filter_conn_by_addr = None  # callables raising on rejection
        self.filter_conn_by_pubkey = None
        self._reconnecting: set[str] = set()
        from tendermint_tpu_torch.p2p.ip_range_counter import IPRangeCounter

        self.ip_ranges = IPRangeCounter()
        # defense-side adversary accounting: how much hostile
        # pressure this switch shed — eclipse dials refused at the
        # IP-range / max-peers gates, admission handshakes rejected
        # (timeouts, incompatible versions/formats, bad bytes), and
        # framing-contract violations that dropped a live peer
        # (oversized frames, recv-ceiling breaches, unknown channels).
        # Exported as p2p_adversary_* on both metric surfaces
        # (node/telemetry.py).
        self.adversary = {
            "ip_range_refused": 0,
            "max_peers_refused": 0,
            "handshake_rejects": 0,
            "frame_violations": 0,
            # commit-schedule disagreements specifically: a nonzero value
            # during a rolling upgrade means some peer runs a different
            # genesis upgrade schedule — the one misconfiguration that
            # would otherwise fork the net AT the flip height. Counted at
            # the add_peer refusal site so both inbound and outbound
            # handshakes land here (docs/upgrade.md).
            "schedule_refused": 0,
        }
        self._mtx = threading.Lock()

    def _note_adversary(self, kind: str) -> None:
        with self._mtx:
            self.adversary[kind] += 1

    def adversary_stats(self) -> dict:
        with self._mtx:
            return dict(self.adversary)

    # -- registry (before start) ------------------------------------------

    def add_reactor(self, name: str, reactor: Reactor) -> Reactor:
        for desc in reactor.get_channels():
            if desc.id in self.reactors_by_ch:
                raise ValueError(f"channel {desc.id:#x} already registered")
            self.ch_descs.append(desc)
            self.reactors_by_ch[desc.id] = reactor
        self.reactors[name] = reactor
        reactor.set_switch(self)
        return reactor

    def reactor(self, name: str) -> Reactor | None:
        return self.reactors.get(name)

    def set_node_info(self, info: NodeInfo) -> None:
        self.node_info = info
        info.channels = bytes(sorted(d.id for d in self.ch_descs))

    def set_node_key(self, priv: PrivKeyEd25519) -> None:
        self.node_priv_key = priv

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        if self.node_info is None:
            from tendermint_tpu_torch.p2p.node_info import default_version
            from tendermint_tpu_torch.version import VERSION

            self.set_node_info(
                NodeInfo(
                    pub_key=self.node_priv_key.pub_key(),
                    moniker="anonymous",
                    network="",
                    version=default_version(VERSION),
                )
            )
        for reactor in self.reactors.values():
            reactor.start()
        for listener in self.listeners:
            t = threading.Thread(
                target=self._listener_routine, args=(listener,), daemon=True,
                name="switch.listener",
            )
            t.start()

    def on_stop(self) -> None:
        for listener in self.listeners:
            try:
                listener.stop()
            except Exception:
                pass
        for peer in self.peers.list():
            self._stop_and_remove(peer, "switch stopping")
        for reactor in self.reactors.values():
            reactor.stop()

    # -- listeners ---------------------------------------------------------

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)

    def start_listener(self, listener) -> None:
        """Add AND serve a listener on a running switch — the
        listener-churn arm of the network chaos tier (on_start owns the
        boot-time set; this is for listeners (re)created later)."""
        self.listeners.append(listener)
        threading.Thread(
            target=self._listener_routine, args=(listener,), daemon=True,
            name="switch.listener",
        ).start()

    def _listener_routine(self, listener) -> None:
        while self.is_running():
            sock = listener.accept()
            if sock is None:
                return  # listener closed
            # handshakes run off-thread: one stalled inbound connection
            # must not block the accept loop
            threading.Thread(
                target=self._accept_peer, args=(sock,), daemon=True,
                name="switch.accept_peer",
            ).start()

    def _accept_peer(self, sock: socket.socket) -> None:
        # inbound cap (switch.go:462-467): beyond max_num_peers an
        # attacker could exhaust fds/threads by dialing in a loop
        max_peers = getattr(self.config, "max_num_peers", 0) if self.config else 0
        if max_peers and self.peers.size() >= max_peers:
            self.logger.info(
                "rejecting inbound peer: at max_num_peers=%d", max_peers
            )
            self._note_adversary("max_peers_refused")
            try:
                sock.close()
            except OSError:
                pass
            return
        # per-IP-range cap (ip_range_counter): counted pre-handshake so a
        # single subnet can't flood the handshake threads either
        ip = ""
        try:
            ip = sock.getpeername()[0]
        except OSError:
            pass
        if ip and not self.ip_ranges.try_add(ip):
            self.logger.info("rejecting inbound peer %s: IP range at limit", ip)
            self._note_adversary("ip_range_refused")
            try:
                sock.close()
            except OSError:
                pass
            return
        stream = SocketStream(sock)
        stream.counted_ip = ip
        try:
            self.add_peer_from_stream(stream, outbound=False)
        except Exception as exc:  # noqa: BLE001 — one bad peer can't kill accept
            self.logger.info("inbound peer rejected: %s", exc)
            self._note_adversary("handshake_rejects")
            self._uncount_stream(stream)
            try:
                sock.close()
            except OSError:
                pass

    # -- peer admission -----------------------------------------------------

    def add_peer_from_stream(
        self,
        stream,
        outbound: bool,
        persistent: bool = False,
        dialed_addr: NetAddress | None = None,
    ) -> Peer:
        # bound the secret-connection + node-info handshakes: a stalled
        # remote must not hold this thread (or the dialing slot) forever
        sock = getattr(stream, "sock", None)
        if sock is not None:
            sock.settimeout(self.peer_config.handshake_timeout)
        try:
            peer = Peer(
                stream,
                outbound=outbound,
                channel_descs=self.ch_descs,
                on_receive=self._on_peer_receive,
                on_error=self._on_peer_error,
                config=self.peer_config,
                node_priv_key=self.node_priv_key,
                persistent=persistent,
            )
            peer.metrics_registry = self.metrics_registry
            peer.dialed_addr = dialed_addr
            peer = self.add_peer(peer)
        finally:
            if sock is not None:
                try:
                    sock.settimeout(None)
                except OSError:
                    pass
        return peer

    def add_peer(self, peer: Peer) -> Peer:
        """Handshake + filter + register + start (switch.go:216-260)."""
        if self.filter_conn_by_pubkey and self.peer_config.auth_enc:
            self.filter_conn_by_pubkey(peer.pub_key())
        info = peer.handshake(self.node_info)
        if info.pub_key.raw == self.node_info.pub_key.raw:
            peer.stream.close()
            raise ConnectionError("refusing self-connection")
        reason = self.node_info.compatible_with(info)
        if reason is not None:
            if reason.startswith("commit schedule mismatch"):
                self._note_adversary("schedule_refused")
            peer.stream.close()
            raise ConnectionError(f"incompatible peer: {reason}")
        # inbound connections respect max_num_peers at the registration
        # point (atomically, inside PeerSet.add) — the accept-loop check is
        # only a fast path, and many concurrent handshakes may be in
        # flight past it (switch.go:462-467)
        cap = 0
        if not peer.outbound and self.config is not None:
            cap = getattr(self.config, "max_num_peers", 0)
        if not self.peers.add(peer, cap=cap):
            peer.stream.close()
            raise ConnectionError(
                f"duplicate peer or at max_num_peers: {peer.id()[:12]}"
            )
        try:
            peer.start()
            for reactor in self.reactors.values():
                reactor.add_peer(peer)
        except Exception:
            self.peers.remove(peer)
            peer.stop()
            raise
        self.logger.info("added peer %s", peer)
        if self.flightrec is not None:
            self.flightrec.record("peer_add", peer=peer.id(),
                                  outbound=peer.outbound)
        return peer

    def _on_peer_receive(self, peer: Peer, ch_id: int, msg_bytes: bytes) -> None:
        reactor = self.reactors_by_ch.get(ch_id)
        if reactor is not None:
            reactor.receive(ch_id, peer, msg_bytes)

    def _on_peer_error(self, peer: Peer, exc: Exception) -> None:
        # framing-contract violations are adversary-shaped: an oversized
        # SecretConnection frame claim / AEAD tamper, a reassembly past
        # a channel's recv ceiling, an unknown channel or packet type —
        # as opposed to plain IO errors (hangups, resets), which stay
        # uncounted. Both classes are TYPED (conn.FrameViolation,
        # SecretConnectionError), never sniffed from message text.
        from tendermint_tpu_torch.p2p.conn import FrameViolation
        from tendermint_tpu_torch.p2p.secret_connection import SecretConnectionError

        if isinstance(exc, (SecretConnectionError, FrameViolation)):
            self._note_adversary("frame_violations")
        self.stop_peer_for_error(peer, exc)

    # -- dialing ------------------------------------------------------------

    def dial_peer_with_address(
        self, addr: NetAddress, persistent: bool = False
    ) -> Peer:
        key = str(addr)
        with self._mtx:
            if key in self.dialing:
                raise ConnectionError(f"already dialing {key}")
            self.dialing.add(key)
        try:
            if self.filter_conn_by_addr:
                self.filter_conn_by_addr(addr)
            sock = socket.create_connection(
                addr.dial_string(), timeout=self.peer_config.dial_timeout
            )
            return self.add_peer_from_stream(
                SocketStream(sock),
                outbound=True,
                persistent=persistent,
                dialed_addr=addr,
            )
        finally:
            with self._mtx:
                self.dialing.discard(key)

    def dial_seeds(self, seeds: list[str], addr_book=None) -> None:
        """Dial in random order, in parallel (switch.go:297-338)."""
        import random

        addrs = [NetAddress.from_string(s) for s in seeds]
        if addr_book is not None:
            for a in addrs:
                if not a.local():
                    addr_book.add_address(a, a)
        random.shuffle(addrs)
        for a in addrs:
            threading.Thread(
                target=self._dial_seed, args=(a,), daemon=True, name="switch.dial"
            ).start()

    def _dial_seed(self, addr: NetAddress) -> None:
        try:
            self.dial_peer_with_address(addr, persistent=True)
        except Exception as exc:  # noqa: BLE001
            # seeds are PERSISTENT peers: a transiently failed boot dial
            # (slow handshake under load, listener not accepting yet)
            # must retry like any dropped persistent peer — fire-once
            # left a permanently degraded mesh (a chaos-tier
            # finding: a 4-node net missing one link can wedge consensus
            # in a 2-2 height split)
            self.logger.info(
                "error dialing seed %s: %s; entering reconnect loop", addr, exc
            )
            self._reconnect_routine(str(addr))

    # -- removal / errors ---------------------------------------------------

    def _uncount_stream(self, stream) -> None:
        """Release an inbound stream's IP-range count exactly once: the
        error path in _accept_peer and peer removal can race (a started
        peer may die while add_peer is still unwinding), and a double
        decrement would steal counts from other live peers.

        The marker lives on the RAW socket stream, which peer admission
        WRAPS (fuzz wrapper, secret connection — each keeps its inner
        stream as `.stream`): walk the chain to find it. Once
        this looked only at the outermost object, so every successfully
        admitted auth_enc inbound peer leaked its count on removal — 16
        churn cycles from one /24 (i.e. any loopback testnet) and the
        node refused ALL inbound forever (the real-TCP chaos tier's
        first catch)."""
        with self._mtx:
            ip = ""
            obj, hops = stream, 0
            while obj is not None and hops < 4:
                ip = getattr(obj, "counted_ip", "")
                if ip:
                    obj.counted_ip = ""
                    break
                obj = getattr(obj, "stream", None)
                hops += 1
        if ip:
            self.ip_ranges.remove(ip)

    def _stop_and_remove(self, peer: Peer, reason) -> None:
        if self.flightrec is not None:
            self.flightrec.record(
                "peer_drop", peer=peer.id(),
                reason="graceful" if reason is None else str(reason)[:200],
            )
        self._uncount_stream(peer.stream)
        self.peers.remove(peer)
        peer.stop()
        for reactor in self.reactors.values():
            reactor.remove_peer(peer, reason)

    def stop_peer_for_error(self, peer: Peer, reason) -> None:
        if not self.peers.has(peer.id()):
            return
        # warning, not info: a peer dropped for cause is an operator-
        # relevant event (and surfaces in pytest's captured-log section
        # when a net test fails)
        self.logger.warning("stopping peer %s for error: %s", peer, reason)
        self._stop_and_remove(peer, reason)
        if peer.persistent and self.is_running():
            # reconnect to the address WE dialed, not anything the peer
            # claimed about itself
            addr = getattr(peer, "dialed_addr", None)
            if addr is not None:
                threading.Thread(
                    target=self._reconnect_routine,
                    args=(str(addr),),
                    daemon=True,
                    name="switch.reconnect",
                ).start()

    def stop_peer_gracefully(self, peer: Peer) -> None:
        self._stop_and_remove(peer, None)

    def _reconnect_routine(self, addr_str: str) -> None:
        with self._mtx:
            if addr_str in self._reconnecting:
                return
            self._reconnecting.add(addr_str)
        try:
            addr = NetAddress.from_string(addr_str)
            attempts, interval = _reconnect_policy()
            for i in range(attempts):
                if not self.is_running():
                    return
                time.sleep(interval)
                try:
                    self.dial_peer_with_address(addr, persistent=True)
                    return
                except Exception as exc:  # noqa: BLE001
                    self.logger.info(
                        "reconnect to %s attempt %d failed: %s", addr_str, i + 1, exc
                    )
        finally:
            with self._mtx:
                self._reconnecting.discard(addr_str)

    # -- messaging ----------------------------------------------------------

    def broadcast(self, ch_id: int, msg_bytes: bytes) -> None:
        """Fire-and-forget TrySend to every peer (switch.go:375-392).
        try_send is non-blocking (queue append or drop), so this runs
        inline — no thread per peer per message."""
        for peer in self.peers.list():
            peer.try_send(ch_id, msg_bytes)

    def num_peers(self) -> tuple[int, int, int]:
        outbound = sum(1 for p in self.peers.list() if p.outbound)
        total = self.peers.size()
        with self._mtx:
            dialing = len(self.dialing)
        return outbound, total - outbound, dialing


# -- test wiring (switch.go:502-547) -----------------------------------------


def make_connected_switches(
    n: int, init_switch, connect=None, switch_factory=None
) -> list[Switch]:
    """n started switches wired pairwise over in-process pipes.
    switch_factory overrides plain Switch() construction (e.g. to set a
    PeerConfig with transport fuzzing, switch.go:502-547's variants)."""
    if switch_factory is None:
        switch_factory = Switch
    switches = [init_switch(i, switch_factory()) for i in range(n)]
    for sw in switches:
        sw.start()
    if connect is None:
        connect = connect2_switches
    for i in range(n):
        for j in range(i + 1, n):
            connect(switches, i, j)
    return switches


def connect2_switches(switches: list[Switch], i: int, j: int) -> None:
    """Full peering of switches[i] <-> switches[j] over a pipe pair."""
    a, b = pipe_pair()
    errs: list = []

    def add(sw, stream, outbound):
        try:
            sw.add_peer_from_stream(stream, outbound=outbound)
        except Exception as exc:  # noqa: BLE001
            errs.append(exc)

    ti = threading.Thread(target=add, args=(switches[i], a, True), daemon=True)
    tj = threading.Thread(target=add, args=(switches[j], b, False), daemon=True)
    ti.start()
    tj.start()
    ti.join(20)
    tj.join(20)
    if errs:
        raise errs[0]
