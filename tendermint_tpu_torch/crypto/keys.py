"""Typed keys and signatures with type-byte unions and RIPEMD-160
addresses (go-crypto shape: a 1-byte type tag followed by the raw bytes).

Ed25519 (type byte 0x01) is the validator key type that the card
verifies in batches; secp256k1 (0x02) is the second key type, with
bitcoin-shaped addresses (ripemd160(sha256(compressed point))) and DER
ECDSA signatures, verified on the CPU (crypto/secp256k1.py).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

from tendermint_tpu_torch.crypto import ed25519, secp256k1
from tendermint_tpu_torch.crypto.hashing import ripemd160

TYPE_ED25519 = 0x01
TYPE_SECP256K1 = 0x02


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

    def verify_bytes(self, msg: bytes, sig) -> bool:
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


@dataclass(frozen=True)
class PrivKeyEd25519:
    raw: bytes  # 32-byte seed

    TYPE = TYPE_ED25519

    def __post_init__(self):
        if len(self.raw) != 32:
            raise ValueError("ed25519 privkey seed must be 32 bytes")

    def pub_key(self) -> PubKeyEd25519:
        return PubKeyEd25519(ed25519.public_key(self.raw))

    def sign(self, msg: bytes) -> SignatureEd25519:
        return SignatureEd25519(ed25519.sign(self.raw, msg))

    def bytes_(self) -> bytes:
        return bytes([self.TYPE]) + self.raw

    def to_json(self):
        return [self.TYPE, self.raw.hex().upper()]

    @classmethod
    def from_json(cls, obj) -> "PrivKeyEd25519":
        if obj[0] != TYPE_ED25519:
            raise ValueError(f"unknown privkey type {obj[0]}")
        return cls(bytes.fromhex(obj[1]))


@dataclass(frozen=True)
class SignatureSecp256k1:
    raw: bytes  # DER, variable length (about 70-72 bytes)

    TYPE = TYPE_SECP256K1

    def __post_init__(self):
        if not 8 <= len(self.raw) <= 80:
            raise ValueError("implausible secp256k1 DER signature length")

    def bytes_(self) -> bytes:
        return bytes([self.TYPE]) + self.raw

    def to_json(self):
        return [self.TYPE, self.raw.hex().upper()]

    @classmethod
    def from_json(cls, obj) -> "SignatureSecp256k1":
        if not isinstance(obj, (list, tuple)) or len(obj) != 2 or obj[0] != TYPE_SECP256K1:
            raise ValueError(f"unknown signature encoding {obj!r}")
        if not isinstance(obj[1], str) or len(obj[1]) > 160:
            raise ValueError("bad signature hex")
        return cls(bytes.fromhex(obj[1]))


@dataclass(frozen=True)
class PubKeySecp256k1:
    raw: bytes  # 33-byte compressed SEC1 point

    TYPE = TYPE_SECP256K1

    def __post_init__(self):
        if len(self.raw) != 33:
            raise ValueError("secp256k1 pubkey must be 33 bytes (compressed)")

    def address(self) -> bytes:
        """ripemd160(sha256(compressed point)), go-crypto's
        PubKeySecp256k1.Address."""
        return ripemd160(hashlib.sha256(self.raw).digest())

    def bytes_(self) -> bytes:
        return bytes([self.TYPE]) + self.raw

    def verify_bytes(self, msg: bytes, sig) -> bool:
        if not isinstance(sig, SignatureSecp256k1):
            return False
        return secp256k1.verify(self.raw, msg, sig.raw)

    def to_json(self):
        return [self.TYPE, self.raw.hex().upper()]

    @classmethod
    def from_json(cls, obj) -> "PubKeySecp256k1":
        if obj[0] != TYPE_SECP256K1:
            raise ValueError(f"unknown pubkey type {obj[0]}")
        return cls(bytes.fromhex(obj[1]))


@dataclass(frozen=True)
class PrivKeySecp256k1:
    raw: bytes  # 32-byte big-endian scalar

    TYPE = TYPE_SECP256K1

    def __post_init__(self):
        if len(self.raw) != 32:
            raise ValueError("secp256k1 privkey must be 32 bytes")

    def pub_key(self) -> PubKeySecp256k1:
        return PubKeySecp256k1(secp256k1.public_key(self.raw))

    def sign(self, msg: bytes) -> SignatureSecp256k1:
        return SignatureSecp256k1(secp256k1.sign(self.raw, msg))

    def bytes_(self) -> bytes:
        return bytes([self.TYPE]) + self.raw

    def to_json(self):
        return [self.TYPE, self.raw.hex().upper()]

    @classmethod
    def from_json(cls, obj) -> "PrivKeySecp256k1":
        if obj[0] != TYPE_SECP256K1:
            raise ValueError(f"unknown privkey type {obj[0]}")
        return cls(bytes.fromhex(obj[1]))


PubKey = PubKeyEd25519 | PubKeySecp256k1
Signature = SignatureEd25519 | SignatureSecp256k1


def gen_priv_key_ed25519(seed: bytes | None = None) -> PrivKeyEd25519:
    """A random key, or one derived from secret material: the secret is
    always sha256-hashed, whatever its length (go-crypto
    GenPrivKeyEd25519FromSecret)."""
    if seed is None:
        return PrivKeyEd25519(os.urandom(32))
    return PrivKeyEd25519(hashlib.sha256(seed).digest())


def gen_priv_key_secp256k1(seed: bytes | None = None) -> PrivKeySecp256k1:
    if seed is None:
        return PrivKeySecp256k1(secp256k1.gen_secret())
    return PrivKeySecp256k1(secp256k1.secret_from_seed(seed))


def pub_key_from_bytes(b: bytes) -> PubKey:
    """Type-tagged key bytes (the `bytes_()` encoding) back to a key; any
    violation is ValueError."""
    if not isinstance(b, (bytes, bytearray)) or len(b) < 1:
        raise ValueError("empty pubkey bytes")
    if b[0] == TYPE_ED25519:
        return PubKeyEd25519(bytes(b[1:]))
    if b[0] == TYPE_SECP256K1:
        return PubKeySecp256k1(bytes(b[1:]))
    raise ValueError(f"unknown pubkey type {b[0]}")


def pub_key_from_json(obj) -> PubKey:
    if not isinstance(obj, (list, tuple)) or len(obj) != 2:
        raise ValueError(f"unknown pubkey encoding {obj!r}")
    if obj[0] == TYPE_ED25519:
        return PubKeyEd25519.from_json(obj)
    if obj[0] == TYPE_SECP256K1:
        return PubKeySecp256k1.from_json(obj)
    raise ValueError(f"unknown pubkey type {obj[0]}")


def priv_key_from_json(obj) -> PrivKeyEd25519 | PrivKeySecp256k1:
    if not isinstance(obj, (list, tuple)) or len(obj) != 2:
        raise ValueError(f"unknown privkey encoding {obj!r}")
    if obj[0] == TYPE_ED25519:
        return PrivKeyEd25519.from_json(obj)
    if obj[0] == TYPE_SECP256K1:
        return PrivKeySecp256k1.from_json(obj)
    raise ValueError(f"unknown privkey type {obj[0]}")


def signature_from_json(obj) -> Signature:
    if not isinstance(obj, (list, tuple)) or len(obj) != 2:
        raise ValueError(f"unknown signature encoding {obj!r}")
    if obj[0] == TYPE_ED25519:
        return SignatureEd25519.from_json(obj)
    if obj[0] == TYPE_SECP256K1:
        return SignatureSecp256k1.from_json(obj)
    raise ValueError(f"unknown signature type {obj[0]}")


def verify_any(pubkey_bytes: bytes, msg: bytes, sig_bytes: bytes) -> bool:
    """Raw-bytes verification dispatching on key shape (32 = ed25519,
    33 = compressed secp256k1): the CPU half of the gateway, whose batch
    items carry raw bytes, not typed objects."""
    if len(pubkey_bytes) == 32:
        return ed25519.verify(pubkey_bytes, msg, sig_bytes)
    if len(pubkey_bytes) == 33:
        return secp256k1.verify(pubkey_bytes, msg, sig_bytes)
    return False
