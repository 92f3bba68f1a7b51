"""Client creators (reference: proxy/client.go:14-76): local in-process
apps share one mutex across all three connections; remote apps get one
socket client per connection."""

from __future__ import annotations

import threading

from tendermint_tpu_torch.abci.client import ABCIClient, LocalClient, SocketClient
from tendermint_tpu_torch.abci.types import Application


class ClientCreator:
    def new_abci_client(self) -> ABCIClient:
        raise NotImplementedError


class LocalClientCreator(ClientCreator):
    def __init__(self, app: Application):
        self.app = app
        self._mtx = threading.RLock()

    def new_abci_client(self) -> ABCIClient:
        return LocalClient(self.app, self._mtx)


class RemoteClientCreator(ClientCreator):
    """Remote app: `transport` picks the wire — "socket" (pipelined
    JSON-lines, the fast default) or "grpc" (proxy/client.go:40-58)."""

    def __init__(self, addr: str, must_connect: bool = True, transport: str = "socket"):
        self.addr = addr
        self.must_connect = must_connect
        self.transport = transport

    def new_abci_client(self) -> ABCIClient:
        if self.transport == "grpc":
            from tendermint_tpu_torch.abci.grpc import GRPCClient

            return GRPCClient(self.addr)
        return SocketClient(self.addr)


def default_client_creator(addr: str, db_dir: str = ".", transport: str = "socket") -> ClientCreator:
    """Name-or-address dispatch (proxy/client.go:64-76): known app names
    create in-process apps; anything else is a TCP address reached over
    `transport` (the config's `abci: socket | grpc`)."""
    from tendermint_tpu_torch.abci.apps import CounterApp, KVStoreApp, NilApp, PersistentKVStoreApp

    if addr in ("kvstore", "dummy"):
        return LocalClientCreator(KVStoreApp())
    if addr in ("persistent_kvstore", "persistent_dummy"):
        return LocalClientCreator(PersistentKVStoreApp(db_dir))
    if addr == "signedkv":
        from tendermint_tpu_torch.abci.apps.signedkv import SignedKVStoreApp

        return LocalClientCreator(SignedKVStoreApp())
    if addr == "counter":
        return LocalClientCreator(CounterApp())
    if addr == "counter_serial":
        return LocalClientCreator(CounterApp(serial=True))
    if addr == "nilapp":
        return LocalClientCreator(NilApp())
    return RemoteClientCreator(addr, transport=transport)
