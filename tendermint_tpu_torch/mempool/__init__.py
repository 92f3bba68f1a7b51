from tendermint_tpu_torch.mempool.mempool import (
    LANES,
    Mempool,
    MempoolFullError,
    MempoolSourceLimitError,
    TxInCacheError,
)

__all__ = [
    "LANES",
    "Mempool",
    "MempoolFullError",
    "MempoolSourceLimitError",
    "TxInCacheError",
]
