"""Commit: the +2/3 precommits for a block (reference:
types/block.go:222-349). Block and Header come with a later slice."""

from __future__ import annotations

from tendermint_tpu_torch.codec import jsonval as jv
from tendermint_tpu_torch.codec.binary import Decoder, Encoder
from tendermint_tpu_torch.merkle.simple import leaf_hash, simple_hash_from_hashes
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, Vote


class Commit:
    """Precommits index-aligned with that height's validator set. A
    precommit is None where its validator skipped."""

    def __init__(self, block_id: BlockID, precommits: list[Vote | None]):
        self.block_id = block_id
        self.precommits = precommits
        self._hash: bytes | None = None
        self._first: Vote | None = None

    def first_precommit(self) -> Vote | None:
        if self._first is None:
            self._first = next((p for p in self.precommits if p is not None), None)
        return self._first

    def height(self) -> int:
        fp = self.first_precommit()
        return fp.height if fp else 0

    def round_(self) -> int:
        fp = self.first_precommit()
        return fp.round_ if fp else 0

    def validate_basic(self) -> str | None:
        """None if structurally valid; else an error string
        (types/block.go:305-338)."""
        if self.block_id.is_zero():
            return "commit cannot be for nil block"
        if not self.precommits:
            return "no precommits in commit"
        height, round_ = self.height(), self.round_()
        for p in self.precommits:
            if p is None:
                continue
            if p.type_ != VOTE_TYPE_PRECOMMIT:
                return f"invalid commit vote type {p.type_}"
            if p.height != height:
                return f"invalid commit precommit height {p.height} != {height}"
            if p.round_ != round_:
                return f"invalid commit precommit round {p.round_} != {round_}"
        return None

    def hash(self) -> bytes:
        """Merkle root over the encoded precommits; None entries hash as the
        empty encoding (types/block.go:340-349)."""
        if self._hash is None:
            leaves = [
                leaf_hash(p.to_bytes() if p is not None else b"")
                for p in self.precommits
            ]
            self._hash = simple_hash_from_hashes(leaves)
        return self._hash

    def encode(self, e: Encoder) -> None:
        self.block_id.encode(e)

        def write_precommit(enc: Encoder, p: Vote | None):
            if p is None:
                enc.write_u8(0)
            else:
                enc.write_u8(1)
                p.encode(enc)

        e.write_list(self.precommits, write_precommit)

    def to_bytes(self) -> bytes:
        e = Encoder()
        self.encode(e)
        return e.buf()

    @classmethod
    def decode(cls, d: Decoder) -> "Commit":
        bid = BlockID.decode(d)

        def read_precommit(dec: Decoder) -> Vote | None:
            if dec.read_u8() == 0:
                return None
            return Vote.decode(dec)

        return cls(bid, d.read_list(read_precommit))

    def to_json(self):
        return {
            "block_id": self.block_id.to_json(),
            "precommits": [p.to_json() if p else None for p in self.precommits],
        }

    @classmethod
    def from_json(cls, obj) -> "Commit":
        obj = jv.require_dict(obj)
        return cls(
            BlockID.from_json(jv.dict_field(obj, "block_id")),
            [
                # only JSON null means "validator skipped"; falsy garbage
                # (0, false, "", {}) must reject, not silently drop a vote
                Vote.from_json(p) if p is not None else None
                for p in jv.list_field(obj, "precommits", jv.MAX_INDEX)
            ],
        )

    def __repr__(self):
        n = sum(1 for p in self.precommits if p is not None)
        return f"Commit{{{n}/{len(self.precommits)} for {self.block_id!r}}}"
