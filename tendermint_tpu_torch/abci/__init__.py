"""ABCI: the application-blockchain interface (SURVEY.md 2.2, reference dep
`tendermint/abci`).

The consensus engine is generic BFT middleware; the replicated state
machine itself is an "application" spoken to over this interface:
Info/SetOption/Query on the query connection, CheckTx on the mempool
connection, InitChain/BeginBlock/DeliverTx/EndBlock/Commit on the
consensus connection (three connections so the three planes never
serialize on one socket — proxy/multi_app_conn.go:12-18).

Includes the example apps every test tier depends on
(proxy/client.go:64-76): kvstore ("dummy"), persistent kvstore, counter,
nilapp.
"""

from tendermint_tpu_torch.abci.types import (
    CODE_OK,
    Application,
    Header as ABCIHeader,
    ResponseCheckTx,
    ResponseCommit,
    ResponseDeliverTx,
    ResponseEndBlock,
    ResponseInfo,
    ResponseQuery,
    ABCIValidator,
)

__all__ = [
    "CODE_OK",
    "Application",
    "ABCIHeader",
    "ResponseCheckTx",
    "ResponseCommit",
    "ResponseDeliverTx",
    "ResponseEndBlock",
    "ResponseInfo",
    "ResponseQuery",
    "ABCIValidator",
]
