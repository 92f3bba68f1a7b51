from tendermint_tpu_torch.proxy.app_conn import (
    AppConnConsensus,
    AppConnMempool,
    AppConnQuery,
)
from tendermint_tpu_torch.proxy.client_creator import (
    ClientCreator,
    LocalClientCreator,
    RemoteClientCreator,
    default_client_creator,
)
from tendermint_tpu_torch.proxy.multi_app_conn import AppConns

__all__ = [
    "AppConnConsensus",
    "AppConnMempool",
    "AppConnQuery",
    "ClientCreator",
    "LocalClientCreator",
    "RemoteClientCreator",
    "default_client_creator",
    "AppConns",
]
