"""TCP listener (reference: p2p/listener.go:51-110).

The JAX package's listener can also try an IGD port mapping (UPnP) for
its external address. The port has no `p2p/upnp.py` yet, so
`skip_upnp=False` raises instead of quietly listening unmapped."""

from __future__ import annotations

import logging
import socket

from tendermint_tpu_torch.p2p.netaddress import NetAddress

logger = logging.getLogger("p2p.listener")


class Listener:
    def __init__(self, laddr: str, skip_upnp: bool = True):
        if not skip_upnp:
            raise NotImplementedError("UPnP port mapping (p2p/upnp.py) is not in the port yet")
        addr = NetAddress.from_string(laddr) if laddr else NetAddress("0.0.0.0", 0)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((addr.ip, addr.port))
        self.sock.listen(64)
        host, port = self.sock.getsockname()[:2]
        self._internal = NetAddress(host, port)
        self._closed = False

    def internal_address(self) -> NetAddress:
        return self._internal

    def external_address(self) -> NetAddress:
        """Best-effort: the address a remote would dial: with a wildcard
        bind, the primary interface address."""
        if self._internal.ip not in ("0.0.0.0", "::"):
            return self._internal
        try:
            probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            probe.connect(("10.255.255.255", 1))
            ip = probe.getsockname()[0]
            probe.close()
        except OSError:
            ip = "127.0.0.1"
        return NetAddress(ip, self._internal.port)

    def accept(self) -> socket.socket | None:
        """Blocks for the next inbound socket; None only once closed.
        Transient accept errors (ECONNABORTED, fd exhaustion) are retried
        — they must not permanently stop inbound peering."""
        import time

        while not self._closed:
            try:
                sock, _ = self.sock.accept()
                return sock
            except OSError:
                if self._closed:
                    return None
                time.sleep(0.1)
        return None

    def stop(self) -> None:
        if not self._closed:
            self._closed = True
            # shutdown-then-close (the socket-teardown rule, here
            # for LISTENING sockets): close() alone does not wake a
            # thread blocked in accept() — the in-flight syscall pins the
            # open file description, so the socket stays bound AND
            # listening until a connection happens to arrive, which both
            # leaks the accept thread and holds the port against a
            # listener restart (the chaos tier's churn arm rebinds the
            # same port on purpose)
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self.sock.close()
            except OSError:
                pass
