"""BlockMeta: the header+blockID summary stored per height
(reference: types/block_meta.go)."""

from __future__ import annotations

from tendermint_tpu_torch.types.block import Header
from tendermint_tpu_torch.types.block_id import BlockID


class BlockMeta:
    def __init__(self, block_id: BlockID, header: Header):
        self.block_id = block_id
        self.header = header

    @classmethod
    def from_block(cls, block, part_set) -> "BlockMeta":
        return cls(BlockID(block.hash(), part_set.header()), block.header)

    def to_json(self):
        return {"block_id": self.block_id.to_json(), "header": self.header.to_json()}

    @classmethod
    def from_json(cls, obj) -> "BlockMeta":
        return cls(BlockID.from_json(obj["block_id"]), Header.from_json(obj["header"]))
