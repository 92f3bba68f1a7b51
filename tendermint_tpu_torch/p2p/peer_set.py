"""Goroutine-safe peer registry keyed by peer id (reference: p2p/peer_set.go)."""

from __future__ import annotations

import threading


class PeerSet:
    def __init__(self):
        self._mtx = threading.Lock()
        self._by_id: dict[str, object] = {}

    def add(self, peer, cap: int = 0) -> bool:
        """Register unless duplicate — or, when cap > 0, unless the set is
        already at cap. The size check must share this lock: admission
        runs on one thread per inbound connection, and a racy pre-check
        alone would let a dial burst exceed the cap arbitrarily."""
        with self._mtx:
            if cap and len(self._by_id) >= cap:
                return False
            if peer.id() in self._by_id:
                return False
            self._by_id[peer.id()] = peer
            return True

    def has(self, peer_id: str) -> bool:
        with self._mtx:
            return peer_id in self._by_id

    def get(self, peer_id: str):
        with self._mtx:
            return self._by_id.get(peer_id)

    def remove(self, peer) -> None:
        with self._mtx:
            self._by_id.pop(peer.id(), None)

    def size(self) -> int:
        with self._mtx:
            return len(self._by_id)

    def list(self) -> list:
        with self._mtx:
            return list(self._by_id.values())
