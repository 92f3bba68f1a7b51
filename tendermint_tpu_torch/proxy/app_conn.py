"""Typed per-connection ABCI views (reference: proxy/app_conn.go:11-41).

Each consumer sees only the subset of calls its connection is allowed to
make: consensus (InitChain/BeginBlock/DeliverTx/EndBlock/Commit), mempool
(CheckTx), query (Info/Query/Echo)."""

from __future__ import annotations

from tendermint_tpu_torch.abci.client import ABCIClient, ReqRes


class AppConnConsensus:
    def __init__(self, client: ABCIClient):
        self._client = client

    def set_response_callback(self, cb) -> None:
        self._client.set_response_callback(cb)

    def error(self):
        return self._client.error()

    def init_chain_sync(self, validators) -> None:
        return self._client.init_chain_sync(validators)

    def begin_block_sync(self, block_hash: bytes, header) -> None:
        return self._client.begin_block_sync(block_hash, header)

    def deliver_tx_async(self, tx: bytes) -> ReqRes:
        return self._client.deliver_tx_async(tx)

    def deliver_txs_async(self, txs: list[bytes]) -> list[ReqRes]:
        return self._client.deliver_txs_async(txs)

    def end_block_sync(self, height: int):
        return self._client.end_block_sync(height)

    def commit_sync(self):
        return self._client.commit_sync()

    def flush_sync(self) -> None:
        self._client.flush_sync()


class AppConnMempool:
    def __init__(self, client: ABCIClient):
        self._client = client

    def set_response_callback(self, cb) -> None:
        self._client.set_response_callback(cb)

    def error(self):
        return self._client.error()

    def check_tx_async(self, tx: bytes) -> ReqRes:
        return self._client.check_tx_async(tx)

    def check_tx_many_async(self, txs: list[bytes]) -> list[ReqRes]:
        return self._client.check_tx_many_async(txs)

    def flush_async(self) -> ReqRes:
        return self._client.flush_async()

    def flush_sync(self) -> None:
        self._client.flush_sync()


class AppConnQuery:
    def __init__(self, client: ABCIClient):
        self._client = client

    def error(self):
        return self._client.error()

    def echo_sync(self, msg: str) -> str:
        return self._client.echo_sync(msg)

    def info_sync(self):
        return self._client.info_sync()

    def query_sync(self, data: bytes, path: str = "", height: int = 0, prove: bool = False):
        return self._client.query_sync(data, path, height, prove)
