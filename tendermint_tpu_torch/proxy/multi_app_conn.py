"""AppConns: the three typed ABCI connections per app, plus the
handshake-on-start hook (reference: proxy/multi_app_conn.go:74-112 —
query, mempool, and consensus clients created in that order, then the
consensus replay handshake runs before the node serves anything)."""

from __future__ import annotations

from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.proxy.app_conn import AppConnConsensus, AppConnMempool, AppConnQuery
from tendermint_tpu_torch.proxy.client_creator import ClientCreator


class AppConns(BaseService):
    def __init__(self, client_creator: ClientCreator, handshaker=None):
        super().__init__("proxy.AppConns")
        self._creator = client_creator
        self._handshaker = handshaker
        self._consensus: AppConnConsensus | None = None
        self._mempool: AppConnMempool | None = None
        self._query: AppConnQuery | None = None

    def consensus(self) -> AppConnConsensus:
        assert self._consensus is not None, "AppConns not started"
        return self._consensus

    def mempool(self) -> AppConnMempool:
        assert self._mempool is not None, "AppConns not started"
        return self._mempool

    def query(self) -> AppConnQuery:
        assert self._query is not None, "AppConns not started"
        return self._query

    def on_start(self) -> None:
        query_cli = self._creator.new_abci_client()
        query_cli.start()
        self._query = AppConnQuery(query_cli)

        mem_cli = self._creator.new_abci_client()
        mem_cli.start()
        self._mempool = AppConnMempool(mem_cli)

        con_cli = self._creator.new_abci_client()
        con_cli.start()
        self._consensus = AppConnConsensus(con_cli)

        if self._handshaker is not None:
            self._handshaker.handshake(self)
