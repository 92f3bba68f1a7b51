"""Mempool tx gossip on channel 0x30 (reference: mempool/reactor.go).

Per-peer broadcast thread walks the mempool CList with blocking
next_wait (reactor.go:114-152), waiting until the peer's height is at
least tx height - 1 before sending, so peers that are far behind aren't
flooded with txs they can't check yet.

The port's copy of the JAX package's `mempool/reactor.py`. One difference:
a device error (ops.gateway.DeviceError) that reaches `receive` from
`check_tx` is not swallowed with the refusals. None does today: the gate
verifies on its own thread and refuses a failed batch's txs
(mempool.SigBatcher), and CheckTx verifies on the host.
"""

from __future__ import annotations

import json
import threading

from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.ops.gateway import DeviceError
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor
from tendermint_tpu_torch.p2p.switch import Reactor

MEMPOOL_CHANNEL = 0x30
PEER_CATCHUP_SLEEP = 0.1


def _encode_tx(tx: bytes) -> bytes:
    return json.dumps({"type": "tx", "tx": tx.hex()}, sort_keys=True).encode()


class MempoolReactor(Reactor, BaseService):
    def __init__(self, config, mempool):
        BaseService.__init__(self, name="mempool.reactor")
        self.config = config
        self.mempool = mempool
        self._peer_threads: dict[str, threading.Thread] = {}
        self._peer_stops: dict[str, threading.Event] = {}
        self._mtx = threading.Lock()

    # -- Reactor interface -------------------------------------------------

    def get_channels(self) -> list[ChannelDescriptor]:
        from tendermint_tpu_torch.codec import jsonval as jv

        return [
            ChannelDescriptor(
                id=MEMPOOL_CHANNEL, priority=5, send_queue_capacity=64,
                # largest legal frame: one MAX_TX_BYTES tx, hex-doubled
                # inside the JSON envelope (right-sized: the
                # 21 MiB block default gave flooders 2.5x headroom)
                recv_message_capacity=2 * jv.MAX_TX_BYTES + 4096,
            )
        ]

    def add_peer(self, peer) -> None:
        if getattr(self.config, "broadcast", True) is False:
            return
        stop = threading.Event()
        t = threading.Thread(
            target=self._broadcast_tx_routine,
            args=(peer, stop),
            daemon=True,
            name=f"mempool.bcast:{peer.id()[:8]}",
        )
        with self._mtx:
            self._peer_stops[peer.id()] = stop
            self._peer_threads[peer.id()] = t
        t.start()

    def remove_peer(self, peer, reason) -> None:
        with self._mtx:
            stop = self._peer_stops.pop(peer.id(), None)
            self._peer_threads.pop(peer.id(), None)
        if stop:
            stop.set()

    @staticmethod
    def _peer_height(peer) -> int | None:
        """The peer's consensus height, from the consensus reactor's
        PeerState mirror when both reactors are wired (the reference reads
        the same shared PeerState, mempool/reactor.go:133-135)."""
        ps = peer.get("ConsensusReactor.peerState")
        return ps.get_height() if ps is not None else None

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        from tendermint_tpu_torch.codec import jsonval as jv

        try:
            msg = json.loads(msg_bytes.decode())
            if not isinstance(msg, dict) or msg.get("type") != "tx":
                raise ValueError("unknown mempool msg")
            tx_hex = jv.str_field(msg, "tx", 2 * jv.MAX_TX_BYTES)
            tx = bytes.fromhex(tx_hex)
        except (ValueError, KeyError, UnicodeDecodeError) as exc:
            self.switch.stop_peer_for_error(peer, exc)
            return
        try:
            # peer id keys the mempool's per-source admission accounting:
            # one flooding peer exhausts ITS budget, not the lanes other
            # sources share
            self.mempool.check_tx(tx, source="peer", source_id=str(peer.id()))
        except DeviceError:
            raise
        except Exception:  # noqa: BLE001 — dup/full/source-limit/app reject: fine
            pass

    # -- gossip ------------------------------------------------------------

    def _broadcast_tx_routine(self, peer, stop: threading.Event) -> None:
        element = None
        while self.is_running() and not stop.is_set():
            if element is None:
                element = self.mempool.txs_front_wait(timeout=0.5)
                if element is None:
                    continue
            mem_tx = element.value
            # don't send txs the peer can't process yet (reactor.go:132-143)
            peer_h = self._peer_height(peer)
            if peer_h is not None and 0 < peer_h < mem_tx.height - 1:
                stop.wait(PEER_CATCHUP_SLEEP)
                continue
            if not peer.send(MEMPOOL_CHANNEL, _encode_tx(mem_tx.tx)):
                # full queue / slow peer: retry while it's still connected
                # (the reference blocks in Send; exiting would silence
                # mempool gossip to this peer forever)
                if not self.switch.peers.has(peer.id()):
                    return
                stop.wait(PEER_CATCHUP_SLEEP)
                continue
            rec = self.mempool.txtrace
            if rec is not None:
                # lifecycle mark: first successful gossip send of this
                # tx to ANY peer (keep-first stamp semantics)
                rec.stamp(mem_tx.tx, "p2p_broadcast")
            # advance strictly once per sent tx
            while self.is_running() and not stop.is_set():
                nxt = element.next_wait(timeout=0.5)
                if nxt is not None:
                    element = nxt
                    break
                if element.removed:
                    element = None  # re-fetch front; cache dedups re-sends
                    break
