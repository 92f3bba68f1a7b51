"""Byte-stream abstraction under MConnection.

Streams expose blocking read(n)/write(b)/close(). TCP sockets and
in-process socketpairs (the net.Pipe() equivalent used by
make_connected_switches, reference p2p/switch.go:502-547) both satisfy it.
"""

from __future__ import annotations

import socket


class SocketStream:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # not a TCP socket (e.g. unix socketpair)

    def read(self, n: int) -> bytes:
        try:
            return self.sock.recv(n)
        except OSError:
            return b""

    def write(self, data: bytes) -> None:
        self.sock.sendall(data)

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()

    def remote_addr(self) -> str:
        try:
            host, port = self.sock.getpeername()[:2]
            return f"{host}:{port}"
        except OSError:
            return "pipe"


def pipe_pair() -> tuple[SocketStream, SocketStream]:
    """In-process full-duplex stream pair (net.Pipe equivalent)."""
    a, b = socket.socketpair()
    return SocketStream(a), SocketStream(b)
