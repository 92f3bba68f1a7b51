"""ConsensusParams: consensus-critical limits that travel in the genesis
doc (reference: types/params.go)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BlockSizeParams:
    max_bytes: int = 22020096  # 21MB (types/params.go:45-51)
    max_txs: int = 10000
    max_gas: int = -1


@dataclass
class TxSizeParams:
    max_bytes: int = 10240  # types/params.go:54-60
    max_gas: int = -1


@dataclass
class BlockGossipParams:
    block_part_size_bytes: int = 65536  # types/params.go:62-68


# Upper bound on a legal block part: the consensus DATA
# channel's reassembly ceiling is sized to carry any part this
# validation admits (a part hex-doubles inside its JSON gossip message,
# plus proof steps — consensus/reactor.get_channels derives from this).
# Without the bound, a genesis declaring a bigger part size would make
# every block-part message a fatal frame violation at the recv ceiling.
MAX_BLOCK_PART_SIZE_BYTES = 1 << 18  # 256 KiB


@dataclass
class ConsensusParams:
    block_size: BlockSizeParams = field(default_factory=BlockSizeParams)
    tx_size: TxSizeParams = field(default_factory=TxSizeParams)
    block_gossip: BlockGossipParams = field(default_factory=BlockGossipParams)

    def validate(self) -> str | None:
        """types/params.go:72-88; None when valid."""
        if self.block_size.max_bytes <= 0:
            return "block_size.max_bytes must be > 0"
        if self.block_gossip.block_part_size_bytes <= 0:
            return "block_gossip.block_part_size_bytes must be > 0"
        if self.block_gossip.block_part_size_bytes > MAX_BLOCK_PART_SIZE_BYTES:
            return (
                "block_gossip.block_part_size_bytes must be <= "
                f"{MAX_BLOCK_PART_SIZE_BYTES} (the consensus data "
                "channel's recv ceiling is sized to this bound)"
            )
        return None

    def to_json(self):
        return {
            "block_size_params": {
                "max_bytes": self.block_size.max_bytes,
                "max_txs": self.block_size.max_txs,
                "max_gas": self.block_size.max_gas,
            },
            "tx_size_params": {
                "max_bytes": self.tx_size.max_bytes,
                "max_gas": self.tx_size.max_gas,
            },
            "block_gossip_params": {
                "block_part_size_bytes": self.block_gossip.block_part_size_bytes,
            },
        }

    @classmethod
    def from_json(cls, obj) -> "ConsensusParams":
        if not obj:
            return cls()
        bs = obj.get("block_size_params", {})
        ts = obj.get("tx_size_params", {})
        bg = obj.get("block_gossip_params", {})
        return cls(
            BlockSizeParams(
                bs.get("max_bytes", 22020096),
                bs.get("max_txs", 10000),
                bs.get("max_gas", -1),
            ),
            TxSizeParams(ts.get("max_bytes", 10240), ts.get("max_gas", -1)),
            BlockGossipParams(bg.get("block_part_size_bytes", 65536)),
        )
