"""Multiplexed prioritized connection (reference: p2p/connection.go).

One physical stream carries many logical channels. Outgoing messages are
chopped into <=1024-byte packets; the send scheduler picks the channel
with the least recently-sent-bytes/priority ratio (connection.go:364-399),
so high-priority channels (votes) preempt bulk ones (block parts) without
starving them. Send and recv are rate-limited with flowrate monitors;
ping/pong guards liveness; a flush throttle batches small writes.

Framing (ours, not go-wire): 1-byte packet type; msg packets are
[type=0x02][channel:1][eof:1][len:2 BE][payload]. Ping=0x01, Pong=0x03.

The stream below can be a TCP socket, a SecretConnection, or an in-memory
socketpair (tests).
"""

from __future__ import annotations

import struct
import threading
import time
from collections import deque
from dataclasses import dataclass

from tendermint_tpu_torch.libs.flowrate import Monitor
from tendermint_tpu_torch.libs.service import BaseService

PACKET_TYPE_PING = 0x01
PACKET_TYPE_MSG = 0x02
PACKET_TYPE_PONG = 0x03

MAX_MSG_PACKET_PAYLOAD_SIZE = 1024  # connection.go:30
_MSG_HEADER = struct.Struct(">BBBH")  # type, channel, eof, payload len


class FrameViolation(ValueError):
    """The peer broke the mconn framing contract: reassembly past a
    channel's recv ceiling, an unknown channel id, or an unknown packet
    type. Typed so the switch's adversary accounting can
    classify it without sniffing message text."""


@dataclass
class MConnConfig:
    """Tunables (connection.go:28-36, config/config.go:245-246)."""

    send_rate: float = 512000.0  # bytes/s
    recv_rate: float = 512000.0
    flush_throttle: float = 0.1  # s
    ping_interval: float = 40.0  # s (pingTimeoutSeconds uses one knob)
    pong_timeout: float = 45.0
    send_queue_capacity: int = 1
    recv_buffer_capacity: int = 4096
    recv_message_capacity: int = 22020096  # 21MB — max block + slack
    send_timeout: float = 10.0  # Channel.sendBytes block limit


@dataclass(frozen=True)
class ChannelDescriptor:
    """Static channel registration (connection.go:510-546)."""

    id: int
    priority: int = 1
    send_queue_capacity: int = 1
    recv_buffer_capacity: int = 4096
    recv_message_capacity: int = 22020096


class _Channel:
    def __init__(self, desc: ChannelDescriptor, cfg: MConnConfig):
        self.desc = desc
        self.id = desc.id
        self.priority = max(desc.priority, 1)
        self.recently_sent = 0  # decayed by flush ticks (connection.go:544)
        self._queue: deque[bytes] = deque()
        self._queue_cap = desc.send_queue_capacity
        self._mtx = threading.Lock()
        self._not_full = threading.Condition(self._mtx)
        self._sending: bytes | None = None
        self._sent_off = 0
        self._recving = bytearray()
        self._recv_cap = desc.recv_message_capacity

    # -- send side ---------------------------------------------------------

    def send_bytes(self, msg: bytes, timeout: float) -> bool:
        """Queue a message; block up to `timeout` if the queue is full."""
        deadline = time.monotonic() + timeout
        with self._not_full:
            while len(self._queue) >= self._queue_cap:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._not_full.wait(left)
            self._queue.append(msg)
            return True

    def try_send_bytes(self, msg: bytes) -> bool:
        with self._mtx:
            if len(self._queue) >= self._queue_cap:
                return False
            self._queue.append(msg)
            return True

    def is_send_pending(self) -> bool:
        with self._mtx:
            return self._sending is not None or bool(self._queue)

    def send_queue_size(self) -> int:
        with self._mtx:
            return len(self._queue) + (1 if self._sending is not None else 0)

    def next_packet(self) -> bytes | None:
        """Pop the next <=1024B packet frame for this channel, or None."""
        with self._not_full:
            if self._sending is None:
                if not self._queue:
                    return None
                self._sending = self._queue.popleft()
                self._sent_off = 0
                self._not_full.notify()
            chunk = self._sending[self._sent_off : self._sent_off + MAX_MSG_PACKET_PAYLOAD_SIZE]
            self._sent_off += len(chunk)
            eof = 1 if self._sent_off >= len(self._sending) else 0
            if eof:
                self._sending = None
                self._sent_off = 0
            frame = _MSG_HEADER.pack(PACKET_TYPE_MSG, self.id, eof, len(chunk)) + chunk
            self.recently_sent += len(frame)
            return frame

    # -- recv side ---------------------------------------------------------

    def recv_packet(self, payload: bytes, eof: bool) -> bytes | None:
        """Reassemble; returns the full message when eof (connection.go:661-677)."""
        if len(self._recving) + len(payload) > self._recv_cap:
            raise FrameViolation(
                f"channel {self.id:#x} message exceeds {self._recv_cap} bytes"
            )
        self._recving += payload
        if eof:
            msg = bytes(self._recving)
            self._recving = bytearray()
            return msg
        return None


class MConnection(BaseService):
    """on_receive(channel_id, msg_bytes) runs on the recv thread;
    on_error(exc) fires once on the first fatal stream error."""

    def __init__(
        self,
        stream,
        channel_descs: list[ChannelDescriptor],
        on_receive,
        on_error,
        config: MConnConfig | None = None,
        name: str = "mconn",
    ):
        super().__init__(name=name)
        self.stream = stream
        self.config = config or MConnConfig()
        self.on_receive = on_receive
        self.on_error = on_error
        self.channels: dict[int, _Channel] = {
            d.id: _Channel(d, self.config) for d in channel_descs
        }
        self.send_monitor = Monitor()
        self.recv_monitor = Monitor()
        self._send_signal = threading.Event()
        self._pong_pending = threading.Event()
        self._last_pong = time.monotonic()
        self._errored = threading.Event()
        self._threads: list[threading.Thread] = []
        self._wmtx = threading.Lock()  # serializes raw stream writes
        # per-peer instrumentation: armed by set_peer_label
        # once the handshake knows who the peer is; None = uninstrumented
        # (pre-handshake traffic, raw harness mconns)
        self._pm = None
        self.last_recv = time.monotonic()

    def set_peer_label(self, peer_id: str, registry=None) -> None:
        """Arm the p2p_peer_* families for this connection. `registry`
        scopes the series (the switch passes the node registry so two
        in-process nodes keep separate counters); default process-wide."""
        from tendermint_tpu_torch.p2p.telemetry import PeerConnMetrics

        self._pm = PeerConnMetrics(peer_id, list(self.channels), registry)

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        for fn, nm in ((self._send_routine, "send"), (self._recv_routine, "recv")):
            t = threading.Thread(target=fn, name=f"{self._name}.{nm}", daemon=True)
            t.start()
            self._threads.append(t)

    def on_stop(self) -> None:
        try:
            self.stream.close()
        except Exception:
            pass
        self._send_signal.set()

    def _fatal(self, exc: Exception) -> None:
        if not self._errored.is_set():
            self._errored.set()
            if self.is_running():
                cb = self.on_error
                if cb is not None:
                    cb(exc)

    # -- public send API ---------------------------------------------------

    def send(self, ch_id: int, msg: bytes) -> bool:
        if not self.is_running():
            return False
        ch = self.channels.get(ch_id)
        if ch is None:
            return False
        ok = ch.send_bytes(msg, self.config.send_timeout)
        if ok:
            self._send_signal.set()
        self._note_send(ch, ok)
        return ok

    def try_send(self, ch_id: int, msg: bytes) -> bool:
        if not self.is_running():
            return False
        ch = self.channels.get(ch_id)
        if ch is None:
            return False
        ok = ch.try_send_bytes(msg)
        if ok:
            self._send_signal.set()
        self._note_send(ch, ok)
        return ok

    def _note_send(self, ch: _Channel, ok: bool) -> None:
        pm = self._pm
        if pm is None:
            return
        if ok:
            pm.queue_sample(ch.id, ch.send_queue_size())
        else:
            pm.send_failure(ch.id)

    def can_send(self, ch_id: int) -> bool:
        ch = self.channels.get(ch_id)
        return ch is not None and ch.send_queue_size() < ch.desc.send_queue_capacity

    # -- send scheduler ----------------------------------------------------

    def _least_ratio_channel(self) -> _Channel | None:
        """Fair pick: min recentlySent/priority among channels with data
        (connection.go:364-399)."""
        best, best_ratio = None, None
        for ch in self.channels.values():
            if not ch.is_send_pending():
                continue
            ratio = ch.recently_sent / ch.priority
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    def _write(self, data: bytes) -> None:
        self.send_monitor.limit(len(data), self.config.send_rate)
        with self._wmtx:
            self.stream.write(data)
        self.send_monitor.update(len(data))

    def _send_routine(self) -> None:
        cfg = self.config
        last_ping = time.monotonic()
        try:
            while self.is_running() and not self._errored.is_set():
                self._send_signal.wait(cfg.flush_throttle)
                self._send_signal.clear()
                now = time.monotonic()
                if self._pong_pending.is_set():
                    self._pong_pending.clear()
                    self._write(bytes([PACKET_TYPE_PONG]))
                if now - last_ping >= cfg.ping_interval:
                    last_ping = now
                    self._write(bytes([PACKET_TYPE_PING]))
                    if self._pm is not None:
                        self._pm.ping_sent()
                    if now - self._last_pong > cfg.ping_interval + cfg.pong_timeout:
                        raise TimeoutError("pong timeout")
                # drain up to a burst of packets, fairly, into one write
                # (connection.go's buffered writer), and while packets
                # remain keep awake instead of waiting out the throttle
                # (connection.go:sendRoutine signals itself again)
                burst = []
                for _ in range(64):
                    ch = self._least_ratio_channel()
                    if ch is None:
                        break
                    frame = ch.next_packet()
                    if frame is None:
                        break
                    burst.append(frame)
                    if self._pm is not None:
                        # frame layout: type, channel, eof (msg done)
                        self._pm.sent_frame(frame[1], len(frame),
                                            bool(frame[2]))
                else:
                    self._send_signal.set()
                if burst:
                    self._write(b"".join(burst))
                # decay fairness counters once per wakeup (connection.go:544)
                for ch in self.channels.values():
                    ch.recently_sent = int(ch.recently_sent * 0.8)
        except Exception as exc:  # noqa: BLE001 — any stream error is fatal here
            self._fatal(exc)

    # -- recv --------------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.stream.read(n - len(buf))
            if not chunk:
                raise ConnectionError("stream closed")
            buf += chunk
        return bytes(buf)

    def _recv_routine(self) -> None:
        cfg = self.config
        try:
            while self.is_running() and not self._errored.is_set():
                head = self._read_exact(1)
                self.recv_monitor.limit(1, cfg.recv_rate)
                self.recv_monitor.update(1)
                ptype = head[0]
                self.last_recv = time.monotonic()
                if ptype == PACKET_TYPE_PING:
                    self._pong_pending.set()
                    self._send_signal.set()
                elif ptype == PACKET_TYPE_PONG:
                    self._last_pong = time.monotonic()
                    if self._pm is not None:
                        self._pm.pong_received()
                elif ptype == PACKET_TYPE_MSG:
                    rest = self._read_exact(_MSG_HEADER.size - 1)
                    ch_id, eof, plen = rest[0], rest[1], (rest[2] << 8) | rest[3]
                    payload = self._read_exact(plen) if plen else b""
                    self.recv_monitor.limit(plen, cfg.recv_rate)
                    self.recv_monitor.update(plen)
                    ch = self.channels.get(ch_id)
                    if ch is None:
                        raise FrameViolation(f"unknown channel {ch_id:#x}")
                    if self._pm is not None:
                        self._pm.recv_packet(ch_id, _MSG_HEADER.size + plen,
                                             bool(eof))
                    msg = ch.recv_packet(payload, bool(eof))
                    if msg is not None and self.on_receive is not None:
                        self.on_receive(ch_id, msg)
                else:
                    raise FrameViolation(f"unknown packet type {ptype:#x}")
        except Exception as exc:  # noqa: BLE001
            self._fatal(exc)

    def status(self) -> dict:
        return {
            "send_rate": self.send_monitor.status().avg_rate,
            "recv_rate": self.recv_monitor.status().avg_rate,
            "channels": {
                f"{ch.id:#x}": ch.send_queue_size() for ch in self.channels.values()
            },
        }
