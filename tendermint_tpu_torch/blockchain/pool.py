"""Parallel block fetcher for fast sync (reference: blockchain/pool.go).

A requester per pending height (<=300 outstanding, <=75 per peer) pulls
blocks from peers concurrently; peers below a minimum receive rate get
dropped (pool.go:14-20, 100-118). The sync loop consumes heights strictly
in order via peek_two_blocks/pop_request; verification failures route back
through redo_request, banning the peer that served the bad block.
"""

from __future__ import annotations

import threading
import time

from tendermint_tpu_torch.libs.flowrate import Monitor
from tendermint_tpu_torch.libs.service import BaseService

MAX_PENDING_REQUESTS = 300  # pool.go:14-20
MAX_PENDING_REQUESTS_PER_PEER = 75
MIN_RECV_RATE = 10240.0  # 10KB/s
PEER_TIMEOUT = 15.0
REQUEST_RETRY_SECONDS = 5.0


class BpPeer:
    def __init__(self, peer_id: str, height: int, base: int = 0):
        self.id = peer_id
        self.height = height
        # the peer's store BASE (lowest height it can serve —
        # >1 on pruned/snapshot-restored peers). 0 = unknown (an older
        # peer whose status_response carries no base): treated as "can
        # serve anything", exactly the pre-retention behavior.
        self.base = base
        self.num_pending = 0
        self.recv_monitor = Monitor()
        self.timeout_at: float | None = None
        self.did_timeout = False

    def reset_monitor(self) -> None:
        self.recv_monitor = Monitor()

    def check_rate(self, now: float) -> bool:
        """True if the peer is too slow (pool.go:100-118)."""
        if self.num_pending == 0 or self.timeout_at is None:
            return False
        if now < self.timeout_at:
            return False
        return self.recv_monitor.status().cur_rate < MIN_RECV_RATE


class BpRequester:
    """One height's fetch state (pool.go:468-515, minus the per-requester
    goroutine: retry/redo runs from the pool's single worker loop)."""

    def __init__(self, height: int):
        self.height = height
        self.peer_id: str | None = None
        self.block = None
        self.requested_at = 0.0
        self.redo = False


class BlockPool(BaseService):
    def __init__(self, start_height: int, request_fn, timeout_fn):
        """request_fn(height, peer_id): send a block request to a peer.
        timeout_fn(peer_id, reason): report an errored/slow peer."""
        super().__init__(name="blockchain.pool")
        self._mtx = threading.Lock()
        self.start_height = start_height  # next height to pop
        self.height = start_height
        self.peers: dict[str, BpPeer] = {}
        self.requesters: dict[int, BpRequester] = {}
        self.max_peer_height = 0
        self.request_fn = request_fn
        self.timeout_fn = timeout_fn

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        self._started_at = time.monotonic()
        threading.Thread(
            target=self._make_requesters_routine, daemon=True, name="pool.requesters"
        ).start()

    def _make_requesters_routine(self) -> None:
        while self.is_running():
            self._spawn_and_retry()
            self.quit_event.wait(0.25)

    def _spawn_and_retry(self) -> None:
        now = time.monotonic()
        sends: list[tuple[int, str]] = []
        with self._mtx:
            # slow-peer detection
            for peer in list(self.peers.values()):
                if peer.check_rate(now):
                    self._remove_peer_locked(peer.id)
                    self.timeout_fn(peer.id, "slow peer")
            # spawn new requesters up to the pipeline limit
            while (
                len(self.requesters) < MAX_PENDING_REQUESTS
                and self.height + len(self.requesters) <= self.max_peer_height
            ):
                h = self.height + len(self.requesters)
                if h in self.requesters:
                    break
                self.requesters[h] = BpRequester(h)
            # (re)assign peers to unserved requesters
            for req in self.requesters.values():
                if req.block is not None:
                    continue
                stale = (
                    req.peer_id is not None
                    and now - req.requested_at > REQUEST_RETRY_SECONDS
                )
                if req.peer_id is None or req.redo or stale:
                    if req.peer_id is not None and (req.redo or stale):
                        old = self.peers.get(req.peer_id)
                        if old:
                            old.num_pending = max(0, old.num_pending - 1)
                    peer = self._pick_available_peer_locked(req.height)
                    req.redo = False
                    if peer is None:
                        req.peer_id = None
                        continue
                    req.peer_id = peer.id
                    req.requested_at = now
                    peer.num_pending += 1
                    if peer.num_pending == 1:
                        peer.reset_monitor()
                        peer.timeout_at = now + PEER_TIMEOUT
                    sends.append((req.height, peer.id))
        for height, peer_id in sends:
            self.request_fn(height, peer_id)

    def _pick_available_peer_locked(self, height: int) -> BpPeer | None:
        for peer in self.peers.values():
            if peer.did_timeout:
                continue
            if peer.num_pending >= MAX_PENDING_REQUESTS_PER_PEER:
                continue
            if peer.height < height:
                continue
            if peer.base > height:
                # the peer PRUNED this height: asking would
                # burn a block_request/no_block_response round trip per
                # retry — ineligible without a wire exchange
                continue
            return peer
        return None

    # -- peer management ---------------------------------------------------

    def set_peer_height(self, peer_id: str, height: int,
                        base: int = 0) -> None:
        with self._mtx:
            peer = self.peers.get(peer_id)
            if peer is None:
                self.peers[peer_id] = BpPeer(peer_id, height, base)
            else:
                peer.height = height
                peer.base = base
            self.max_peer_height = max(self.max_peer_height, height)

    def remove_peer(self, peer_id: str) -> None:
        with self._mtx:
            self._remove_peer_locked(peer_id)

    def _remove_peer_locked(self, peer_id: str) -> None:
        self.peers.pop(peer_id, None)
        for req in self.requesters.values():
            if req.peer_id == peer_id and req.block is None:
                req.peer_id = None

    # -- block intake ------------------------------------------------------

    def add_block(self, peer_id: str, block, block_size: int) -> None:
        with self._mtx:
            req = self.requesters.get(block.header.height)
            if req is None or req.peer_id != peer_id or req.block is not None:
                return  # unsolicited or duplicate
            req.block = block
            peer = self.peers.get(peer_id)
            if peer:
                peer.num_pending = max(0, peer.num_pending - 1)
                peer.recv_monitor.update(block_size)
                if peer.num_pending == 0:
                    peer.timeout_at = None
                else:
                    peer.timeout_at = time.monotonic() + PEER_TIMEOUT

    # -- ordered consumption ----------------------------------------------

    def peek_two_blocks(self):
        with self._mtx:
            first = self.requesters.get(self.height)
            second = self.requesters.get(self.height + 1)
            return (
                first.block if first else None,
                second.block if second else None,
            )

    def peek_blocks(self, k: int) -> list:
        """The contiguous run of downloaded blocks from the pool height,
        up to k long (stops at the first gap) — the verify pipeline's
        lookahead window."""
        with self._mtx:
            out = []
            for h in range(self.height, self.height + k):
                req = self.requesters.get(h)
                if req is None or req.block is None:
                    break
                out.append(req.block)
            return out

    def pop_request(self) -> None:
        with self._mtx:
            self.requesters.pop(self.height, None)
            self.height += 1

    def peer_has_no_block(self, peer_id: str, height: int) -> None:
        """Peer answered a request with no_block_response: clear the
        assignment (without banning) so another peer gets picked."""
        with self._mtx:
            req = self.requesters.get(height)
            if req is None or req.peer_id != peer_id or req.block is not None:
                return
            req.peer_id = None
            peer = self.peers.get(peer_id)
            if peer:
                peer.num_pending = max(0, peer.num_pending - 1)

    def redo_request(self, height: int) -> str | None:
        """Bad block at `height`: drop the peer that sent it, refetch
        (pool.go RedoRequest + reactor.go:239)."""
        with self._mtx:
            req = self.requesters.get(height)
            if req is None:
                return None
            bad_peer = req.peer_id
            req.block = None
            req.peer_id = None
            req.redo = True
            if bad_peer:
                self._remove_peer_locked(bad_peer)
            return bad_peer

    def below_horizon(self) -> int | None:
        """The network's retained horizon when fast sync can NEVER make
        progress from here: every known peer that is ahead of
        us has pruned the next height we need (its base is above our
        pool height). Returns the lowest such base — the height the
        network retains back to — or None while any peer could still
        serve. Peers that never reported a base (older peers) read as
        base=0 = "serves everything", so mixed nets never false-trigger."""
        with self._mtx:
            ahead = [
                p for p in self.peers.values() if p.height >= self.height
            ]
            if not ahead:
                return None
            if all(p.base > self.height for p in ahead):
                return min(p.base for p in ahead)
            return None

    # -- status ------------------------------------------------------------

    def is_caught_up(self) -> bool:
        """pool.go:128-142: need at least one peer, and either a synced
        block or 5s elapsed (so a just-connected peer's not-yet-reported
        height can't fake instant catch-up), and be at max peer height."""
        with self._mtx:
            if not self.peers:
                return False
            received_or_timed_out = (
                self.height > self.start_height
                or time.monotonic() - self._started_at > 5.0
            )
            return received_or_timed_out and self.height >= self.max_peer_height

    def status(self) -> tuple[int, int]:
        with self._mtx:
            pending = sum(1 for r in self.requesters.values() if r.block is None)
            return self.height, pending
