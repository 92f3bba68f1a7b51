"""Per-IP-range connection counting (reference: p2p/ip_range_counter.go
AddToIPRangeCounts / CheckIPRangeCounts, there left unwired — here the
switch uses it to cap inbound peers per address range).

An IPv4 address belongs to one range per prefix depth: its /8, /16 and
/24. Limits are per depth: e.g. (64, 32, 16) allows at most 64 inbound
peers sharing a first octet, 32 sharing two, 16 sharing three — a cheap
sybil dampener: one botnet subnet cannot occupy the whole inbound peer
budget.
"""

from __future__ import annotations

import threading


class IPRangeCounter:
    def __init__(self, limits: tuple[int, ...] = (64, 32, 16)):
        self.limits = limits
        self._counts: dict[str, int] = {}
        self._mtx = threading.Lock()

    @staticmethod
    def _prefixes(ip: str) -> list[str]:
        parts = ip.split(".")
        if len(parts) != 4:
            return [ip]  # non-IPv4: one bucket for the whole literal
        return [".".join(parts[: i + 1]) for i in range(3)]

    def try_add(self, ip: str) -> bool:
        """Count `ip` against its ranges; False (and no change) if any
        range is at its limit."""
        prefixes = self._prefixes(ip)
        with self._mtx:
            for i, p in enumerate(prefixes):
                limit = self.limits[min(i, len(self.limits) - 1)]
                if self._counts.get(p, 0) >= limit:
                    return False
            for p in prefixes:
                self._counts[p] = self._counts.get(p, 0) + 1
            return True

    def remove(self, ip: str) -> None:
        with self._mtx:
            for p in self._prefixes(ip):
                n = self._counts.get(p, 0) - 1
                if n <= 0:
                    self._counts.pop(p, None)
                else:
                    self._counts[p] = n

    def count(self, prefix: str) -> int:
        with self._mtx:
            return self._counts.get(prefix, 0)
