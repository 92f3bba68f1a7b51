"""Vote: a signed prevote/precommit (reference: types/vote.go).

Sign bytes are canonical JSON wrapped with the chain id, the reference's
CanonicalJSONOnceVote layout (types/canonical_json.go:27-33, 52-55), so a
vote's signed payload is reproducible byte for byte from its fields.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from tendermint_tpu_torch.codec import jsonval as jv
from tendermint_tpu_torch.codec.binary import Decoder, Encoder
from tendermint_tpu_torch.codec.canonical import canonical_dumps
from tendermint_tpu_torch.crypto.keys import (
    Signature,
    SignatureEd25519,
    SignatureSecp256k1,
    signature_from_json,
)
from tendermint_tpu_torch.types.block_id import BlockID

VOTE_TYPE_PREVOTE = 0x01
VOTE_TYPE_PRECOMMIT = 0x02


def is_vote_type_valid(t: int) -> bool:
    return t in (VOTE_TYPE_PREVOTE, VOTE_TYPE_PRECOMMIT)


class VoteError(Exception):
    pass


class UnexpectedStepError(VoteError):
    pass


class InvalidValidatorIndexError(VoteError):
    pass


class InvalidValidatorAddressError(VoteError):
    pass


class InvalidSignatureError(VoteError):
    pass


class ConflictingVotesError(VoteError):
    def __init__(self, vote_a: "Vote", vote_b: "Vote"):
        super().__init__("conflicting votes")
        self.vote_a = vote_a
        self.vote_b = vote_b


@dataclass(frozen=True)
class Vote:
    validator_address: bytes
    validator_index: int
    height: int
    round_: int
    type_: int
    block_id: BlockID
    signature: Signature | None = None

    def canonical(self) -> dict:
        """CanonicalJSONVote field set — excludes the signature and the
        validator identity (types/canonical_json.go:27-33)."""
        return {
            "block_id": self.block_id.canonical(),
            "height": self.height,
            "round": self.round_,
            "type": self.type_,
        }

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_dumps({"chain_id": chain_id, "vote": self.canonical()})

    def with_signature(self, sig: Signature) -> "Vote":
        return replace(self, signature=sig)

    def encode(self, e: Encoder) -> None:
        e.write_bytes(self.validator_address)
        e.write_varint(self.validator_index)
        e.write_varint(self.height)
        e.write_varint(self.round_)
        e.write_u8(self.type_)
        self.block_id.encode(e)
        if self.signature is None:
            e.write_u8(0)
        elif self.signature.TYPE == SignatureEd25519.TYPE:
            e.write_raw(self.signature.bytes_())  # type byte + fixed 64-byte body
        else:
            e.write_u8(self.signature.TYPE)
            e.write_bytes(self.signature.raw)  # variable DER: length-prefixed

    def to_bytes(self) -> bytes:
        e = Encoder()
        self.encode(e)
        return e.buf()

    @classmethod
    def decode(cls, d: Decoder) -> "Vote":
        addr = d.read_bytes()
        idx = d.read_varint()
        height = d.read_varint()
        rnd = d.read_varint()
        typ = d.read_u8()
        bid = BlockID.decode(d)
        sig_type = d.read_u8()
        sig = None
        if sig_type == SignatureEd25519.TYPE:
            sig = SignatureEd25519(d.read_raw(64))
        elif sig_type == SignatureSecp256k1.TYPE:
            sig = SignatureSecp256k1(d.read_bytes())
        elif sig_type != 0:
            raise ValueError(f"unknown signature type {sig_type}")
        return cls(addr, idx, height, rnd, typ, bid, sig)

    @classmethod
    def from_bytes(cls, b: bytes) -> "Vote":
        return cls.decode(Decoder(b))

    def to_json(self):
        return {
            "validator_address": self.validator_address.hex().upper(),
            "validator_index": self.validator_index,
            "height": self.height,
            "round": self.round_,
            "type": self.type_,
            "block_id": self.block_id.to_json(),
            "signature": self.signature.to_json() if self.signature else None,
        }

    @classmethod
    def from_json(cls, obj) -> "Vote":
        return cls(
            jv.hex_field(obj, "validator_address"),
            jv.int_field(obj, "validator_index", 0, jv.MAX_INDEX),
            jv.int_field(obj, "height", 0, jv.MAX_HEIGHT),
            jv.int_field(obj, "round", 0, jv.MAX_ROUND),
            jv.int_field(obj, "type", 0, 255),
            BlockID.from_json(jv.dict_field(obj, "block_id")),
            signature_from_json(obj["signature"]) if obj.get("signature") else None,
        )

    def __repr__(self):
        t = {VOTE_TYPE_PREVOTE: "Prevote", VOTE_TYPE_PRECOMMIT: "Precommit"}.get(
            self.type_, f"?{self.type_}"
        )
        return (
            f"Vote{{{self.validator_index}:{self.validator_address.hex()[:8]} "
            f"{self.height}/{self.round_:02d}/{t} {self.block_id.hash.hex()[:8]}}}"
        )
