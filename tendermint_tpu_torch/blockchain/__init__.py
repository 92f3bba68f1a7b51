from tendermint_tpu_torch.blockchain.store import BlockStore

__all__ = ["BlockStore"]
