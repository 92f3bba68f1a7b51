"""BlockID and PartSetHeader (reference: types/block.go:414-443,
types/part_set.go:60-85)."""

from __future__ import annotations

from dataclasses import dataclass, field

from tendermint_tpu_torch.codec import jsonval as jv
from tendermint_tpu_torch.codec.binary import Decoder, Encoder


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0

    def canonical(self) -> dict:
        """CanonicalJSONPartSetHeader (types/canonical_json.go:14-17)."""
        return {"hash": self.hash, "total": self.total}

    def encode(self, e: Encoder) -> None:
        e.write_varint(self.total)
        e.write_bytes(self.hash)

    @classmethod
    def decode(cls, d: Decoder) -> "PartSetHeader":
        total = d.read_varint()
        h = d.read_bytes()
        return cls(total, h)

    def to_json(self):
        return {"total": self.total, "hash": self.hash.hex().upper()}

    @classmethod
    def from_json(cls, obj) -> "PartSetHeader":
        return cls(
            jv.int_field(obj, "total", 0, jv.MAX_INDEX),
            jv.hex_field(obj, "hash"),
        )

    def __repr__(self):
        return f"PartSetHeader({self.total}:{self.hash.hex()[:12]})"


ZERO_PSH = PartSetHeader()


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    parts_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        return len(self.hash) == 0 and self.parts_header.is_zero()

    def key(self) -> bytes:
        """Machine key for VoteSet's votes-by-block map
        (types/block.go:433-435)."""
        e = Encoder()
        self.parts_header.encode(e)
        return self.hash + e.buf()

    def canonical(self):
        """CanonicalJSONBlockID; a zero BlockID canonicalizes with hash
        omitted (omitempty, types/canonical_json.go:9-12)."""
        if self.is_zero():
            return {"parts": self.parts_header.canonical()}
        return {"hash": self.hash, "parts": self.parts_header.canonical()}

    def encode(self, e: Encoder) -> None:
        e.write_bytes(self.hash)
        self.parts_header.encode(e)

    @classmethod
    def decode(cls, d: Decoder) -> "BlockID":
        h = d.read_bytes()
        psh = PartSetHeader.decode(d)
        return cls(h, psh)

    def to_json(self):
        return {"hash": self.hash.hex().upper(), "parts": self.parts_header.to_json()}

    @classmethod
    def from_json(cls, obj) -> "BlockID":
        return cls(
            jv.hex_field(obj, "hash"),
            PartSetHeader.from_json(jv.dict_field(obj, "parts")),
        )

    def __repr__(self):
        return f"BlockID({self.hash.hex()[:12]}:{self.parts_header!r})"


ZERO_BLOCK_ID = BlockID()
