"""Network addresses (reference: p2p/netaddress.go).

Addresses are `ip:port` strings with routability classification used by
the address book to decide what to gossip.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass


@dataclass(frozen=True)
class NetAddress:
    ip: str
    port: int

    @classmethod
    def from_string(cls, s: str) -> "NetAddress":
        host, _, port = s.rpartition(":")
        if not host or not port:
            raise ValueError(f"invalid address {s!r}")
        return cls(host, int(port))

    def __str__(self) -> str:
        return f"{self.ip}:{self.port}"

    def dial_string(self) -> tuple[str, int]:
        return self.ip, self.port

    # -- classification (netaddress.go:171-252) ---------------------------

    def _addr(self):
        try:
            return ipaddress.ip_address(self.ip)
        except ValueError:
            return None

    def valid(self) -> bool:
        return self._addr() is not None and 0 < self.port < 65536

    def local(self) -> bool:
        a = self._addr()
        return a is not None and (a.is_loopback or a.is_unspecified)

    def routable(self) -> bool:
        """Globally routable: valid and not loopback/private/link-local."""
        a = self._addr()
        if a is None or not (0 < self.port < 65536):
            return False
        return not (
            a.is_loopback
            or a.is_private
            or a.is_link_local
            or a.is_multicast
            or a.is_unspecified
            or a.is_reserved
        )

    def same_network(self, other: "NetAddress", bits: int = 16) -> bool:
        a, b = self._addr(), other._addr()
        if a is None or b is None or a.version != b.version:
            return False
        net = ipaddress.ip_network(f"{self.ip}/{bits}", strict=False)
        return b in net

    def to_json(self):
        return str(self)

    @classmethod
    def from_json(cls, s: str) -> "NetAddress":
        return cls.from_string(s)
