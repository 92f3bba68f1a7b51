"""Proof-carrying read cache (docs/serving.md § Read replicas).

Entries are keyed ``(path, key, height)`` and hold an upstream
``/abci_query`` response TOGETHER with its statetree proof — verified by
the daemon against a light-verified header BEFORE insertion, so nothing
unproven is ever served. The cache itself is dumb storage plus
invalidation bookkeeping; all verification lives in the daemon.

Invalidation: each new verified block reports its txs through
``note_block``. In the default ``keys`` mode the kvstore wire format
(``key=value``, or the bare tx as its own key) is parsed and only the
touched keys lose their serve-latest eligibility; ``all`` mode
(``TENDERMINT_REPLICA_INVALIDATE=all``, for apps with opaque txs whose
write sets a replica cannot parse) invalidates every key on any
non-empty block. Either way the entries themselves stay — a
height-pinned query can still serve an old proof; only "give me the
latest" reads consult the touch log. Under-invalidation in ``keys``
mode against a non-kvstore app is bounded by the daemon's
``max_lag_heights`` staleness window, never unbounded.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from tendermint_tpu_torch.libs.envknob import env_str


class ProofCache:
    """LRU over (path, key_hex, height) -> verified response entries."""

    def __init__(self, max_entries: int = 10_000):
        self.max_entries = max(1, int(max_entries))
        self._mtx = threading.Lock()
        self._entries: OrderedDict[tuple[str, str, int], dict] = OrderedDict()
        # (path, key) -> newest cached proof height for that key
        self._latest: dict[tuple[str, str], int] = {}
        # key -> last block height that wrote it (keys mode)
        self._touched: dict[str, int] = {}
        # last block height that invalidated EVERYTHING (all mode)
        self._touched_all_at = 0
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    @staticmethod
    def _mode() -> str:
        return env_str("TENDERMINT_REPLICA_INVALIDATE", "keys",
                       allowed=("keys", "all"))

    # -- reads ------------------------------------------------------------

    def get(self, path: str, key_hex: str, height: int) -> dict | None:
        """The exact entry proven at `height`, or None."""
        k = (path, key_hex.lower(), int(height))
        with self._mtx:
            ent = self._entries.get(k)
            if ent is None:
                self.misses += 1
                return None
            self._entries.move_to_end(k)
            self.hits += 1
            return ent

    def get_latest(self, path: str, key_hex: str, floor: int) -> dict | None:
        """The newest cached entry for (path, key) that is still a valid
        answer for "the latest value": proven at or above `floor` (the
        staleness window) AND not overwritten by any verified block since
        its proof height. None = the daemon must refetch."""
        key_hex = key_hex.lower()
        with self._mtx:
            h = self._latest.get((path, key_hex))
            if h is None or h < floor:
                self.misses += 1
                return None
            if max(self._touched.get(key_hex, 0), self._touched_all_at) > h:
                # the key changed after this proof's height: a fresh
                # proof exists upstream and serving this one would be a
                # stale read beyond the invalidation contract
                self.misses += 1
                return None
            ent = self._entries.get((path, key_hex, h))
            if ent is None:  # evicted by LRU under the _latest pointer
                self.misses += 1
                return None
            self._entries.move_to_end((path, key_hex, h))
            self.hits += 1
            return ent

    # -- writes -----------------------------------------------------------

    def put(self, path: str, key_hex: str, height: int, entry: dict) -> None:
        key_hex = key_hex.lower()
        k = (path, key_hex, int(height))
        with self._mtx:
            self._entries[k] = entry
            self._entries.move_to_end(k)
            cur = self._latest.get((path, key_hex), 0)
            if height >= cur:
                self._latest[(path, key_hex)] = int(height)
            while len(self._entries) > self.max_entries:
                (p, kh, h), _ = self._entries.popitem(last=False)
                if self._latest.get((p, kh)) == h:
                    del self._latest[(p, kh)]

    def note_block(self, height: int, txs: list[bytes]) -> None:
        """Record the write set of verified block `height` (called by the
        daemon AFTER header verification, never on raw upstream data)."""
        if not txs:
            return
        with self._mtx:
            if self._mode() == "all":
                self._touched_all_at = max(self._touched_all_at, int(height))
                self.invalidations += 1
                return
            for tx in txs:
                key = tx.partition(b"=")[0] or tx
                kh = key.hex().lower()
                if self._touched.get(kh, 0) < height:
                    self._touched[kh] = int(height)
                    self.invalidations += 1

    def prune(self, floor: int) -> None:
        """Forget touch log rows at or below `floor` — once every entry
        the daemon can still serve was proven above a touch height, the
        row carries no information (bounds memory to the live window)."""
        with self._mtx:
            self._touched = {
                k: h for k, h in self._touched.items() if h > floor
            }

    def stats(self) -> dict:
        with self._mtx:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
            }
