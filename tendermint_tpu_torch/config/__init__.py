from tendermint_tpu_torch.config.config import (
    BaseConfig,
    Config,
    ConsensusConfig,
    MempoolConfig,
    P2PConfig,
    RPCConfig,
    default_config,
    test_config,
)
from tendermint_tpu_torch.config.toml import ensure_root, load_config, reset_test_root

__all__ = [
    "Config",
    "BaseConfig",
    "RPCConfig",
    "P2PConfig",
    "MempoolConfig",
    "ConsensusConfig",
    "default_config",
    "test_config",
    "ensure_root",
    "load_config",
    "reset_test_root",
]
