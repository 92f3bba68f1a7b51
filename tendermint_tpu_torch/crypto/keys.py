"""Typed Ed25519 keys and signatures with type-byte unions and RIPEMD-160
addresses (go-crypto shape: a 1-byte type tag followed by the raw bytes).

Only Ed25519 (type byte 0x01) is ported so far. A secp256k1 key or
signature (0x02) raises NotImplementedError rather than verifying as
false: the port must never give a different verdict from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.crypto import ed25519
from tendermint_tpu_torch.crypto.hashing import ripemd160

TYPE_ED25519 = 0x01
TYPE_SECP256K1 = 0x02


def _secp256k1_not_ported():
    return NotImplementedError("secp256k1 keys are not ported to tendermint_tpu_torch yet")


@dataclass(frozen=True)
class SignatureEd25519:
    raw: bytes  # 64 bytes

    TYPE = TYPE_ED25519

    def __post_init__(self):
        if len(self.raw) != 64:
            raise ValueError("ed25519 signature must be 64 bytes")

    def bytes_(self) -> bytes:
        return bytes([self.TYPE]) + self.raw

    def to_json(self):
        return [self.TYPE, self.raw.hex().upper()]

    @classmethod
    def from_json(cls, obj) -> "SignatureEd25519":
        if not isinstance(obj, (list, tuple)) or len(obj) != 2 or obj[0] != TYPE_ED25519:
            raise ValueError(f"unknown signature encoding {obj!r}")
        if not isinstance(obj[1], str) or len(obj[1]) != 128:
            raise ValueError("bad signature hex")
        return cls(bytes.fromhex(obj[1]))


@dataclass(frozen=True)
class PubKeyEd25519:
    raw: bytes  # 32 bytes

    TYPE = TYPE_ED25519

    def __post_init__(self):
        if len(self.raw) != 32:
            raise ValueError("ed25519 pubkey must be 32 bytes")

    def address(self) -> bytes:
        """20-byte address: ripemd160 over the tagged key bytes."""
        return ripemd160(self.bytes_())

    def bytes_(self) -> bytes:
        return bytes([self.TYPE]) + self.raw

    def verify_bytes(self, msg: bytes, sig: SignatureEd25519) -> bool:
        """Sequential CPU verify (reference types/vote_set.go:175)."""
        if not isinstance(sig, SignatureEd25519):
            return False
        return ed25519.verify(self.raw, msg, sig.raw)

    def to_json(self):
        return [self.TYPE, self.raw.hex().upper()]

    @classmethod
    def from_json(cls, obj) -> "PubKeyEd25519":
        if not isinstance(obj, (list, tuple)) or len(obj) != 2 or obj[0] != TYPE_ED25519:
            raise ValueError(f"unknown pubkey encoding {obj!r}")
        if not isinstance(obj[1], str) or len(obj[1]) != 64:
            raise ValueError("bad pubkey hex")
        return cls(bytes.fromhex(obj[1]))


def pub_key_from_json(obj) -> PubKeyEd25519:
    if not isinstance(obj, (list, tuple)) or len(obj) != 2:
        raise ValueError(f"unknown pubkey encoding {obj!r}")
    if obj[0] == TYPE_SECP256K1:
        raise _secp256k1_not_ported()
    return PubKeyEd25519.from_json(obj)


def signature_from_json(obj) -> SignatureEd25519:
    if not isinstance(obj, (list, tuple)) or len(obj) != 2:
        raise ValueError(f"unknown signature encoding {obj!r}")
    if obj[0] == TYPE_SECP256K1:
        raise _secp256k1_not_ported()
    return SignatureEd25519.from_json(obj)


def verify_any(pubkey_bytes: bytes, msg: bytes, sig_bytes: bytes) -> bool:
    """Raw-bytes verification dispatching on key shape (32 = ed25519,
    33 = compressed secp256k1, not ported yet) — the CPU half of the
    gateway."""
    if len(pubkey_bytes) == 32:
        return ed25519.verify(pubkey_bytes, msg, sig_bytes)
    if len(pubkey_bytes) == 33:
        raise _secp256k1_not_ported()
    return False
