"""ChaCha20-Poly1305 AEAD (RFC 8439) — in-repo implementation with two
opportunistic fast paths: the `cryptography` package (when importable)
and direct ctypes bindings to the system libcrypto (crypto/_openssl.py,
present on most hosts even where the Python package is not).

The second half of the SecretConnection crypto hole (see crypto/x25519.py
for the first): every encrypted p2p frame rides this AEAD, so the
pure-Python path must be correct AND fast enough to carry real multi-node
consensus gossip when no native route exists. The ChaCha20 core therefore
runs vectorized in numpy with the state held as a (4, 4, nblocks) grid —
each round's four column (then four diagonal) quarter-rounds execute as
ONE lane-parallel quarter-round over whole rows, and the per-frame
Poly1305 key rides the same keystream call as the payload (block 0 =
one-time key, blocks 1.. = cipher stream), so a full 1024-byte
SecretConnection frame costs one vectorized sweep. Poly1305, inherently
serial, runs Horner-style on Python 130-bit ints.

All three paths are pinned to the RFC 8439 section 2.x test vectors and
cross-checked byte-for-byte (tests/test_secure_transport.py).

Backend selection shares TENDERMINT_SECRETCONN_BACKEND with x25519
(auto|pure|native|openssl; a pinned backend that is unavailable raises
loudly — never a silent downgrade).

Side channels: the pure path is not constant-time (numpy/bigint); the
tag COMPARISON is (hmac.compare_digest). docs/secure-p2p.md carries the
threat-model discussion.
"""

from __future__ import annotations

import hmac
import struct

import numpy as np

from tendermint_tpu_torch.crypto import _openssl
from tendermint_tpu_torch.crypto.x25519 import resolve_backend  # shared knob

KEY_LEN = 32
NONCE_LEN = 12
TAG_LEN = 16

_SIGMA = np.frombuffer(b"expand 32-byte k", dtype="<u4").copy()
_MASK128 = (1 << 128) - 1
_P1305 = (1 << 130) - 5
_RCLAMP = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF


class InvalidTag(ValueError):
    """AEAD authentication failed: tampered/truncated ciphertext, wrong
    key, or reordered/replayed frame (counter-nonce desync)."""


# -- ChaCha20 core (lane-parallel over blocks AND the 4 columns) --------------


def _quarter_round(a, b, c, d) -> None:
    # rows of shape (4, nblocks): one call = four quarter-rounds across
    # every block lane (mutates in place; callers pass views or temps)
    a += b
    d ^= a
    d[:] = (d << np.uint32(16)) | (d >> np.uint32(16))
    c += d
    b ^= c
    b[:] = (b << np.uint32(12)) | (b >> np.uint32(20))
    a += b
    d ^= a
    d[:] = (d << np.uint32(8)) | (d >> np.uint32(24))
    c += d
    b ^= c
    b[:] = (b << np.uint32(7)) | (b >> np.uint32(25))


def _keystream(key: bytes, counter: int, nonce: bytes, nbytes: int) -> bytes:
    if len(key) != KEY_LEN:
        raise ValueError(f"chacha20 key must be {KEY_LEN} bytes, got {len(key)}")
    if len(nonce) != NONCE_LEN:
        raise ValueError(f"chacha20 nonce must be {NONCE_LEN} bytes, got {len(nonce)}")
    nblocks = max(1, (nbytes + 63) // 64)
    x = np.empty((4, 4, nblocks), dtype=np.uint32)
    x[0] = _SIGMA[:, None]
    x[1:3].reshape(8, nblocks)[:] = np.frombuffer(key, dtype="<u4")[:, None]
    # the 32-bit block counter wraps modulo 2^32 (RFC 8439 section 2.3)
    x[3, 0] = ((counter + np.arange(nblocks, dtype=np.uint64)) & 0xFFFFFFFF).astype(
        np.uint32
    )
    x[3, 1:4] = np.frombuffer(nonce, dtype="<u4")[:, None]
    init = x.copy()
    a, b, c, d = x[0], x[1], x[2], x[3]
    for _ in range(10):
        _quarter_round(a, b, c, d)
        # diagonal round: rotate rows 1..3 so diagonals align as columns
        b2 = np.roll(b, -1, axis=0)
        c2 = np.roll(c, -2, axis=0)
        d2 = np.roll(d, -3, axis=0)
        _quarter_round(a, b2, c2, d2)
        b[:] = np.roll(b2, 1, axis=0)
        c[:] = np.roll(c2, 2, axis=0)
        d[:] = np.roll(d2, 3, axis=0)
    x += init
    # serialize block-major: block i = the 16 words [:, :, i], little-endian
    return (
        np.ascontiguousarray(x.reshape(16, nblocks).T).astype("<u4").tobytes()[:nbytes]
    )


def chacha20_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    """One 64-byte keystream block (RFC 8439 section 2.3)."""
    return _keystream(key, counter, nonce, 64)


def chacha20_xor(key: bytes, counter: int, nonce: bytes, data: bytes) -> bytes:
    """Encrypt/decrypt (RFC 8439 section 2.4) — XOR with the keystream
    starting at `counter`."""
    if not data:
        return b""
    ks = _keystream(key, counter, nonce, len(data))
    return (
        np.frombuffer(data, dtype=np.uint8) ^ np.frombuffer(ks, dtype=np.uint8)
    ).tobytes()


# -- Poly1305 -----------------------------------------------------------------


def poly1305_mac(key: bytes, msg: bytes) -> bytes:
    """RFC 8439 section 2.5 one-time authenticator (32-byte key = r||s)."""
    if len(key) != 32:
        raise ValueError(f"poly1305 key must be 32 bytes, got {len(key)}")
    r = int.from_bytes(key[:16], "little") & _RCLAMP
    s = int.from_bytes(key[16:], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i : i + 16]
        acc = (acc + int.from_bytes(block, "little") + (1 << (8 * len(block)))) * r % _P1305
    return ((acc + s) & _MASK128).to_bytes(16, "little")


def poly1305_key_gen(key: bytes, nonce: bytes) -> bytes:
    """RFC 8439 section 2.6: the one-time key is the first half of
    keystream block 0."""
    return chacha20_block(key, 0, nonce)[:32]


# -- AEAD (RFC 8439 section 2.8) ----------------------------------------------


def _pad16(n: int) -> bytes:
    return b"\x00" * (-n % 16)


def _mac_data(aad: bytes, ct: bytes) -> bytes:
    return (
        aad
        + _pad16(len(aad))
        + ct
        + _pad16(len(ct))
        + struct.pack("<QQ", len(aad), len(ct))
    )


def seal(key: bytes, nonce: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
    """ciphertext || 16-byte tag."""
    # one keystream sweep: block 0 carries the poly1305 one-time key,
    # blocks 1.. carry the cipher stream (identical bytes to separate
    # counter-0/counter-1 calls, minus a second vectorization setup)
    ks = _keystream(key, 0, nonce, 64 + len(plaintext))
    if plaintext:
        ct = (
            np.frombuffer(plaintext, dtype=np.uint8)
            ^ np.frombuffer(ks[64:], dtype=np.uint8)
        ).tobytes()
    else:
        ct = b""
    return ct + poly1305_mac(ks[:32], _mac_data(aad, ct))


def open_(key: bytes, nonce: bytes, boxed: bytes, aad: bytes = b"") -> bytes:
    """Verify-then-decrypt; raises InvalidTag on any authentication
    failure (incl. a truncated box — a short frame can't carry a tag)."""
    if len(boxed) < TAG_LEN:
        raise InvalidTag("ciphertext shorter than the tag")
    ct, tag = boxed[:-TAG_LEN], boxed[-TAG_LEN:]
    ks = _keystream(key, 0, nonce, 64 + len(ct))
    want = poly1305_mac(ks[:32], _mac_data(aad, ct))
    if not hmac.compare_digest(tag, want):
        raise InvalidTag("poly1305 tag mismatch")
    if not ct:
        return b""
    return (
        np.frombuffer(ct, dtype=np.uint8) ^ np.frombuffer(ks[64:], dtype=np.uint8)
    ).tobytes()


# -- backend-dispatching AEAD object (the `cryptography` surface) -------------

try:  # pragma: no cover - env dependent
    from cryptography.hazmat.primitives.ciphers.aead import (
        ChaCha20Poly1305 as _NativeAEAD,
    )

    _HAVE_NATIVE = True
except ImportError:  # pragma: no cover - env dependent
    _HAVE_NATIVE = False


def have_native() -> bool:
    return _HAVE_NATIVE


class ChaCha20Poly1305:
    """Drop-in for `cryptography`'s AEAD class; `backend` records which
    implementation serves this instance ('pure'|'native'|'openssl')."""

    __slots__ = ("_key", "_native", "backend")

    def __init__(self, key: bytes, backend: str | None = None):
        if len(key) != KEY_LEN:
            raise ValueError(f"key must be {KEY_LEN} bytes, got {len(key)}")
        self._key = bytes(key)
        self.backend = backend if backend is not None else resolve_backend()
        self._native = _NativeAEAD(self._key) if self.backend == "native" else None

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None = None) -> bytes:
        if self._native is not None:
            return self._native.encrypt(nonce, data, aad)
        if self.backend == "openssl":
            return _openssl.aead_seal(self._key, nonce, data, aad or b"")
        return seal(self._key, nonce, data, aad or b"")

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None = None) -> bytes:
        if self._native is not None:
            try:
                return self._native.decrypt(nonce, data, aad)
            except Exception as exc:  # cryptography.exceptions.InvalidTag
                # ONE exception type across backends, so the transport's
                # tamper triage never depends on which path served
                raise InvalidTag(str(exc) or "poly1305 tag mismatch") from exc
        if self.backend == "openssl":
            pt = _openssl.aead_open(self._key, nonce, data, aad or b"")
            if pt is None:
                raise InvalidTag("poly1305 tag mismatch")
            return pt
        return open_(self._key, nonce, data, aad or b"")
