"""Peer-exchange reactor on channel 0x00 (reference: p2p/pex_reactor.go).

Request/response gossip of known addresses; ensures a minimum number of
outbound peers every ensure_peers_period; per-peer inbound message rate
limit (pex_reactor.go:14-26: 1000 msgs / 10min window equivalent).
"""

from __future__ import annotations

import json
import random
import threading
import time

from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.p2p.addrbook import AddrBook
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.switch import Reactor

PEX_CHANNEL = 0x00
DEFAULT_ENSURE_PEERS_PERIOD = 30.0
MIN_NUM_OUTBOUND_PEERS = 10
MAX_MSG_COUNT_BY_PEER = 1000
MSG_COUNT_WINDOW = 600.0


def _encode(msg: dict) -> bytes:
    return json.dumps(msg, sort_keys=True).encode()


class PEXReactor(Reactor, BaseService):
    def __init__(self, book: AddrBook, ensure_peers_period: float = DEFAULT_ENSURE_PEERS_PERIOD):
        BaseService.__init__(self, name="p2p.pex")
        self.book = book
        self.ensure_peers_period = ensure_peers_period
        self.min_outbound = MIN_NUM_OUTBOUND_PEERS
        self._msg_counts: dict[str, list[float]] = {}
        self._mtx = threading.Lock()

    # -- Reactor interface -------------------------------------------------

    def get_channels(self) -> list[ChannelDescriptor]:
        # a pex_addrs message carries <= 250 "host:port" strings — 64 KiB
        # bounds it with an order of magnitude to spare (the default
        # receive ceiling is the 21 MiB block cap)
        return [ChannelDescriptor(id=PEX_CHANNEL, priority=1,
                                  send_queue_capacity=10,
                                  recv_message_capacity=1 << 16)]

    def add_peer(self, peer) -> None:
        info = peer.node_info
        if info and info.listen_addr:
            try:
                addr = NetAddress.from_string(info.listen_addr)
                if peer.outbound:
                    # we dialed them: address verified good
                    self.book.mark_good(addr)
                    if self.book.need_more_addrs():
                        self._request_addrs(peer)
                else:
                    self.book.add_address(addr, addr)
                    # learn more from inbound peers
                    self._request_addrs(peer)
            except ValueError:
                pass

    def remove_peer(self, peer, reason) -> None:
        with self._mtx:
            self._msg_counts.pop(peer.id(), None)

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        if self._flood_check(peer):
            # evict the flooder's address — but only one provably theirs:
            # listen_addr is self-reported in the handshake, so anyone
            # could otherwise claim a victim's address and have us evict
            # a proven-good entry. Require the claimed IP to match the
            # socket's actual remote IP.
            info = peer.node_info
            if info and info.listen_addr:
                try:
                    claimed = NetAddress.from_string(info.listen_addr)
                    sock_ip = str(peer.stream.remote_addr()).rsplit(":", 1)[0]
                    if claimed.ip == sock_ip:
                        self.book.mark_bad(claimed)
                except (ValueError, AttributeError):
                    pass
            self.switch.stop_peer_for_error(peer, "pex flood")
            return
        try:
            msg = json.loads(msg_bytes.decode())
            if not isinstance(msg, dict):
                raise ValueError("pex message not an object")
        except (ValueError, UnicodeDecodeError):
            self.switch.stop_peer_for_error(peer, "bad pex message")
            return
        if msg.get("type") == "pex_request":
            addrs = [str(a) for a in self.book.get_selection()]
            peer.try_send(PEX_CHANNEL, _encode({"type": "pex_addrs", "addrs": addrs}))
        elif msg.get("type") == "pex_addrs":
            src_str = peer.node_info.listen_addr if peer.node_info else ""
            try:
                src = NetAddress.from_string(src_str) if src_str else None
            except ValueError:
                src = None
            sent = msg.get("addrs", [])
            if not isinstance(sent, list):
                self.switch.stop_peer_for_error(peer, "bad pex addrs")
                return
            for s in sent[:250]:
                if not isinstance(s, str) or len(s) > 64:
                    continue  # garbage entry; the cap bounds parsing work
                try:
                    addr = NetAddress.from_string(s)
                except ValueError:
                    continue
                self.book.add_address(addr, src or addr)

    def _flood_check(self, peer) -> bool:
        now = time.monotonic()
        with self._mtx:
            times = self._msg_counts.setdefault(peer.id(), [])
            times.append(now)
            while times and now - times[0] > MSG_COUNT_WINDOW:
                times.pop(0)
            return len(times) > MAX_MSG_COUNT_BY_PEER

    def _request_addrs(self, peer) -> None:
        peer.try_send(PEX_CHANNEL, _encode({"type": "pex_request"}))

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        self.book.start()
        threading.Thread(
            target=self._ensure_peers_routine, daemon=True, name="pex.ensure"
        ).start()

    def on_stop(self) -> None:
        self.book.stop()

    def _ensure_peers_routine(self) -> None:
        # stagger startup so a fleet doesn't dial in lockstep
        time.sleep(random.random() * self.ensure_peers_period / 10)
        self._ensure_peers()
        while not self.quit_event.wait(self.ensure_peers_period):
            self._ensure_peers()

    def _ensure_peers(self) -> None:
        if not hasattr(self, "switch") or not self.switch.is_running():
            return
        outbound, _inbound, dialing = self.switch.num_peers()
        need = self.min_outbound - (outbound + dialing)
        if need <= 0:
            return
        connected = {
            p.node_info.listen_addr
            for p in self.switch.peers.list()
            if p.node_info
        }
        tried: set[str] = set()
        for _ in range(need * 3):
            addr = self.book.pick_address()
            if addr is None:
                break
            key = str(addr)
            if key in tried or key in connected or key in self.book.our_addresses():
                continue
            tried.add(key)
            self.book.mark_attempt(addr)
            threading.Thread(
                target=self._dial, args=(addr,), daemon=True, name="pex.dial"
            ).start()
            need -= 1
            if need <= 0:
                break
        # still starving: ask a random current peer for more addresses
        if need > 0:
            peers = self.switch.peers.list()
            if peers:
                self._request_addrs(random.choice(peers))

    def _dial(self, addr: NetAddress) -> None:
        try:
            self.switch.dial_peer_with_address(addr)
            self.book.mark_good(addr)
        except Exception as exc:  # noqa: BLE001
            self.logger.info("pex dial %s failed: %s", addr, exc)
