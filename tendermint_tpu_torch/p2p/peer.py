"""Peer: one remote node (reference: p2p/peer.go).

Connection layering: raw stream -> [fuzz wrapper] -> [secret connection]
-> NodeInfo handshake -> MConnection. AuthEnc defaults on
(p2p/peer.go:54-77).
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field

from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor, MConnConfig, MConnection
from tendermint_tpu_torch.p2p.node_info import MAX_NODE_INFO_SIZE, NodeInfo

_HS_LEN = struct.Struct(">I")


@dataclass
class PeerConfig:
    """p2p/peer.go:54-77."""

    auth_enc: bool = True
    handshake_timeout: float = 20.0
    dial_timeout: float = 3.0
    fuzz: bool = False
    fuzz_config: dict = field(default_factory=dict)
    mconfig: MConnConfig = field(default_factory=MConnConfig)


def _raw_sock(stream):
    """The raw socket under a wrapper chain (fuzz wrapper, secret
    connection — each keeps its inner stream as `.stream`), or None for
    socketless streams (in-process test fabrics)."""
    obj, hops = stream, 0
    while obj is not None and hops < 4:
        sock = getattr(obj, "sock", None)
        if sock is not None:
            return sock
        obj = getattr(obj, "stream", None)
        hops += 1
    return None


def exchange_node_info(stream, our_info: NodeInfo, timeout: float) -> NodeInfo:
    """Concurrent length-prefixed NodeInfo swap (p2p/peer.go:159-200).
    Write first, then read — both sides do the same, so no deadlock
    (payloads are far below socket buffer sizes).

    The deadline is ABSOLUTE: the switch's admission timeout
    used to bound each socket READ at `timeout`, so a byte-dribbling
    peer — one byte every timeout-minus-epsilon — could hold the
    admission thread for MAX_NODE_INFO_SIZE reads (a slow-loris against
    the handshake path). Every read now re-arms the socket with the
    REMAINING budget, exactly like the SecretConnection handshake; the
    prior socket timeout is restored on exit so the caller's own
    bookkeeping (Switch.add_peer_from_stream) is undisturbed."""
    import socket as _socket

    deadline = (
        time.monotonic() + timeout if timeout and timeout > 0 else None
    )
    sock = _raw_sock(stream)
    prior = None
    if sock is not None:
        try:
            prior = sock.gettimeout()
        except OSError:
            sock = None

    def arm() -> None:
        if deadline is None or sock is None:
            return
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise ConnectionError("node-info handshake timed out")
        try:
            sock.settimeout(remaining)
        except OSError:
            pass

    def read_exact(n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            arm()
            try:
                chunk = stream.read(n - len(buf))
            except _socket.timeout as exc:
                raise ConnectionError(
                    "node-info handshake timed out"
                ) from exc
            if not chunk:
                # SocketStream swallows OSError (incl. timeouts) into
                # b"" — distinguish deadline expiry from a peer hangup
                if deadline is not None and time.monotonic() >= deadline:
                    raise ConnectionError("node-info handshake timed out")
                raise ConnectionError(
                    "stream closed during node-info handshake"
                )
            buf += chunk
        return bytes(buf)

    try:
        raw = our_info.encode()
        arm()
        stream.write(_HS_LEN.pack(len(raw)) + raw)
        (ln,) = _HS_LEN.unpack(read_exact(_HS_LEN.size))
        if ln > MAX_NODE_INFO_SIZE:
            raise ValueError(f"node info too large: {ln}")
        return NodeInfo.decode(read_exact(ln))
    finally:
        if sock is not None:
            try:
                sock.settimeout(prior)
            except OSError:
                pass


class Peer(BaseService):
    def __init__(
        self,
        stream,
        outbound: bool,
        channel_descs: list[ChannelDescriptor],
        on_receive,  # (peer, ch_id, msg_bytes)
        on_error,  # (peer, exc)
        config: PeerConfig,
        node_priv_key,
        persistent: bool = False,
    ):
        super().__init__(name="peer")
        self.outbound = outbound
        self.persistent = persistent
        self.config = config
        self.node_info: NodeInfo | None = None
        self.data: dict = {}  # per-peer reactor state (e.g. PeerState)
        # registry scoping the p2p_peer_* series: the switch
        # sets this from its own metrics_registry before handshake; None
        # falls back to the process-wide registry
        self.metrics_registry = None

        if config.fuzz:
            from tendermint_tpu_torch.p2p.fuzz import FuzzedStream

            stream = FuzzedStream(stream, **config.fuzz_config)
        if config.auth_enc:
            from tendermint_tpu_torch.p2p.secret_connection import SecretConnection

            stream = SecretConnection(stream, node_priv_key)
        self.stream = stream

        self.mconn = MConnection(
            stream,
            channel_descs,
            on_receive=lambda ch, msg: on_receive(self, ch, msg),
            on_error=lambda exc: on_error(self, exc),
            config=config.mconfig,
        )

    # -- handshake (before start) -----------------------------------------

    def handshake(self, our_info: NodeInfo) -> NodeInfo:
        self.node_info = exchange_node_info(
            self.stream, our_info, self.config.handshake_timeout
        )
        if self.config.auth_enc:
            # the identity that signed the secret-connection challenge must
            # be the identity claimed in NodeInfo (p2p/peer.go:181-191)
            if self.stream.remote_pubkey().raw != self.node_info.pub_key.raw:
                raise ConnectionError("node info pubkey != secret conn pubkey")
        self.mconn._name = f"mconn:{self.id()[:8]}"
        # identity is known now: arm the per-peer instrument families
        # (p2p/telemetry.py) on whichever registry scopes this peer
        self.mconn.set_peer_label(self.id(), self.metrics_registry)
        return self.node_info

    # -- identity ----------------------------------------------------------

    def id(self) -> str:
        return self.node_info.id() if self.node_info else "?"

    def pub_key(self):
        if self.config.auth_enc:
            return self.stream.remote_pubkey()
        return self.node_info.pub_key if self.node_info else None

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        # The switch arms an admission timeout on the RAW socket for the
        # handshakes (Switch.add_peer_from_stream) and restores it to
        # blocking only AFTER add_peer returns — but the mconn recv
        # routine starts HERE, inside add_peer, and CPython fixes a
        # recv's deadline at call entry, so its first blocking read
        # inherited the armed timeout. A link quiet past the remaining
        # budget (mconn pings only every 40 s; a loaded box delays the
        # remote's first gossip sends arbitrarily) then tripped the
        # timeout, which SocketStream.read reports as EOF — both sides
        # dropped "stream closed" with nothing wrong on the wire (a
        # full-suite fast-sync flake). Clearing the timeout
        # BEFORE the recv routine launches closes the race; the
        # handshakes this timeout actually bounds are all complete by
        # the time start() runs.
        obj, hops = self.stream, 0
        while obj is not None and hops < 4:
            sock = getattr(obj, "sock", None)
            if sock is not None:
                try:
                    sock.settimeout(None)
                except OSError:
                    pass
                break
            obj = getattr(obj, "stream", None)
            hops += 1
        self.mconn.start()

    def on_stop(self) -> None:
        self.mconn.stop()

    # -- messaging ---------------------------------------------------------

    def send(self, ch_id: int, msg: bytes) -> bool:
        return self.mconn.send(ch_id, msg)

    def try_send(self, ch_id: int, msg: bytes) -> bool:
        return self.mconn.try_send(ch_id, msg)

    def can_send(self, ch_id: int) -> bool:
        return self.mconn.can_send(ch_id)

    def last_recv_age(self) -> float:
        """Seconds since ANY packet arrived on this connection — the
        per-peer staleness signal (p2p_peer_last_recv_age_seconds,
        refreshed at collect time by node/telemetry.py)."""
        return time.monotonic() - self.mconn.last_recv

    def get(self, key: str):
        return self.data.get(key)

    def set(self, key: str, value) -> None:
        self.data[key] = value

    def status(self) -> dict:
        st = self.mconn.status()
        st["node_info"] = self.node_info.to_json() if self.node_info else None
        return st

    def __repr__(self) -> str:
        arrow = "->" if self.outbound else "<-"
        return f"Peer{{{arrow} {self.id()[:12]}}}"
