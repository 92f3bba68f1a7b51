from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.ticker import MockTicker, TimeoutTicker
from tendermint_tpu_torch.consensus.wal import WAL

__all__ = ["ConsensusState", "TimeoutTicker", "MockTicker", "WAL"]
