from tendermint_tpu_torch.blockchain.pool import BlockPool
from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
from tendermint_tpu_torch.blockchain.store import BlockStore

__all__ = ["BlockPool", "BlockStore", "BlockchainReactor"]
