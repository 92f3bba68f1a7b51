"""Proposal: signed (height, round, block parts header, POL round/blockID)
(reference: types/proposal.go). POLRound is -1 when there is no
proof-of-lock."""

from __future__ import annotations

from dataclasses import dataclass, replace

from tendermint_tpu_torch.codec.binary import Decoder, Encoder
from tendermint_tpu_torch.codec.canonical import canonical_dumps
from tendermint_tpu_torch.crypto.keys import (
    SignatureEd25519,
    SignatureSecp256k1,
    signature_from_json,
)
from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader


@dataclass(frozen=True)
class Proposal:
    height: int
    round_: int
    block_parts_header: PartSetHeader
    pol_round: int = -1
    pol_block_id: BlockID = BlockID()
    signature: SignatureEd25519 | None = None

    def canonical(self) -> dict:
        """CanonicalJSONProposal (types/canonical_json.go:19-25)."""
        return {
            "block_parts_header": self.block_parts_header.canonical(),
            "height": self.height,
            "pol_block_id": self.pol_block_id.canonical(),
            "pol_round": self.pol_round,
            "round": self.round_,
        }

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_dumps({"chain_id": chain_id, "proposal": self.canonical()})

    def with_signature(self, sig: SignatureEd25519) -> "Proposal":
        return replace(self, signature=sig)

    def encode(self, e: Encoder) -> None:
        e.write_varint(self.height)
        e.write_varint(self.round_)
        self.block_parts_header.encode(e)
        e.write_varint(self.pol_round)
        self.pol_block_id.encode(e)
        if self.signature is None:
            e.write_u8(0)
        elif self.signature.TYPE == SignatureEd25519.TYPE:
            e.write_raw(self.signature.bytes_())  # fixed 64-byte body
        else:
            e.write_u8(self.signature.TYPE)
            e.write_bytes(self.signature.raw)  # variable DER: length-prefixed

    def to_bytes(self) -> bytes:
        e = Encoder()
        self.encode(e)
        return e.buf()

    @classmethod
    def decode(cls, d: Decoder) -> "Proposal":
        height = d.read_varint()
        rnd = d.read_varint()
        psh = PartSetHeader.decode(d)
        pol_round = d.read_varint()
        pol_bid = BlockID.decode(d)
        sig_type = d.read_u8()
        sig = None
        if sig_type == SignatureEd25519.TYPE:
            sig = SignatureEd25519(d._take(64))
        elif sig_type == SignatureSecp256k1.TYPE:
            sig = SignatureSecp256k1(d.read_bytes())
        elif sig_type != 0:
            raise ValueError(f"unknown signature type {sig_type}")
        return cls(height, rnd, psh, pol_round, pol_bid, sig)

    @classmethod
    def from_bytes(cls, b: bytes) -> "Proposal":
        return cls.decode(Decoder(b))

    def to_json(self):
        return {
            "height": self.height,
            "round": self.round_,
            "block_parts_header": self.block_parts_header.to_json(),
            "pol_round": self.pol_round,
            "pol_block_id": self.pol_block_id.to_json(),
            "signature": self.signature.to_json() if self.signature else None,
        }

    @classmethod
    def from_json(cls, obj) -> "Proposal":
        from tendermint_tpu_torch.codec import jsonval as jv

        return cls(
            jv.int_field(obj, "height", 0, jv.MAX_HEIGHT),
            jv.int_field(obj, "round", 0, jv.MAX_ROUND),
            PartSetHeader.from_json(jv.dict_field(obj, "block_parts_header")),
            jv.int_field(obj, "pol_round", -1, jv.MAX_ROUND),
            BlockID.from_json(jv.dict_field(obj, "pol_block_id")),
            signature_from_json(obj["signature"]) if obj.get("signature") else None,
        )

    def __repr__(self):
        return (
            f"Proposal{{{self.height}/{self.round_} {self.block_parts_header!r} "
            f"POL:{self.pol_round}}}"
        )
