"""Heartbeat: signed liveness message a proposer broadcasts while waiting
for transactions in no-empty-blocks mode (reference: types/heartbeat.go,
fired from consensus/state.go:818)."""

from __future__ import annotations

from dataclasses import dataclass, replace

from tendermint_tpu_torch.codec.canonical import canonical_dumps
from tendermint_tpu_torch.crypto.keys import SignatureEd25519, signature_from_json


@dataclass(frozen=True)
class Heartbeat:
    validator_address: bytes
    validator_index: int
    height: int
    round_: int
    sequence: int
    signature: SignatureEd25519 | None = None

    def canonical(self) -> dict:
        """CanonicalJSONHeartbeat (types/canonical_json.go:35-41)."""
        return {
            "height": self.height,
            "round": self.round_,
            "sequence": self.sequence,
            "validator_address": self.validator_address,
            "validator_index": self.validator_index,
        }

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_dumps({"chain_id": chain_id, "heartbeat": self.canonical()})

    def with_signature(self, sig: SignatureEd25519) -> "Heartbeat":
        return replace(self, signature=sig)

    def to_json(self):
        return {
            "validator_address": self.validator_address.hex().upper(),
            "validator_index": self.validator_index,
            "height": self.height,
            "round": self.round_,
            "sequence": self.sequence,
            "signature": self.signature.to_json() if self.signature else None,
        }

    @classmethod
    def from_json(cls, obj) -> "Heartbeat":
        from tendermint_tpu_torch.codec import jsonval as jv

        return cls(
            jv.hex_field(obj, "validator_address"),
            jv.int_field(obj, "validator_index", 0, jv.MAX_INDEX),
            jv.int_field(obj, "height", 0, jv.MAX_HEIGHT),
            jv.int_field(obj, "round", 0, jv.MAX_ROUND),
            jv.int_field(obj, "sequence", 0, jv.MAX_ROUND),
            signature_from_json(obj["signature"]) if obj.get("signature") else None,
        )
