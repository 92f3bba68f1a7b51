"""Validator: address + pubkey + voting power + round-robin accumulator
(reference: types/validator.go)."""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.codec.binary import Encoder
from tendermint_tpu_torch.crypto.hashing import ripemd160
from tendermint_tpu_torch.crypto.keys import PubKey, pub_key_from_json


@dataclass
class Validator:
    address: bytes
    pub_key: PubKey  # ed25519 or secp256k1
    voting_power: int
    accum: int = 0

    @classmethod
    def new(cls, pub_key: PubKey, voting_power: int) -> "Validator":
        return cls(pub_key.address(), pub_key, voting_power, 0)

    def copy(self) -> "Validator":
        return Validator(self.address, self.pub_key, self.voting_power, self.accum)

    def compare_accum(self, other: "Validator | None") -> "Validator":
        """Higher accum wins; ties break to the smaller address
        (types/validator.go:43-59)."""
        if other is None:
            return self
        if self.accum != other.accum:
            return self if self.accum > other.accum else other
        if self.address == other.address:
            raise ValueError("cannot compare identical validators")
        return self if self.address < other.address else other

    def hash(self) -> bytes:
        """Identity hash, excluding the round-volatile accum
        (types/validator.go:73-86)."""
        e = Encoder()
        e.write_bytes(self.address)
        e.write_raw(self.pub_key.bytes_())
        e.write_varint(self.voting_power)
        return ripemd160(e.buf())

    def to_json(self):
        return {
            "address": self.address.hex().upper(),
            "pub_key": self.pub_key.to_json(),
            "voting_power": self.voting_power,
            "accum": self.accum,
        }

    @classmethod
    def from_json(cls, obj) -> "Validator":
        return cls(
            bytes.fromhex(obj["address"]),
            pub_key_from_json(obj["pub_key"]),
            obj["voting_power"],
            obj.get("accum", 0),
        )

    def __repr__(self):
        return (
            f"Validator{{{self.address.hex()[:8]} VP:{self.voting_power} A:{self.accum}}}"
        )
