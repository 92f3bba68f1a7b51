"""Example ABCI applications (reference: the abci package's dummy /
persistent_dummy / counter / nilapp, selected by name at
proxy/client.go:64-76)."""

from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp, PersistentKVStoreApp
from tendermint_tpu_torch.abci.apps.counter import CounterApp
from tendermint_tpu_torch.abci.apps.nilapp import NilApp
from tendermint_tpu_torch.abci.apps.signedkv import SignedKVStoreApp

__all__ = [
    "KVStoreApp", "PersistentKVStoreApp", "CounterApp", "NilApp",
    "SignedKVStoreApp",
]
