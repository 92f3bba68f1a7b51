"""X25519 (RFC 7748) — in-repo Montgomery-ladder implementation plus an
OpenSSL-backed fast path (via the `cryptography` package) when available.

This closes the last third-party crypto hole in the repo: the p2p
SecretConnection (station-to-station handshake) needs no `cryptography`
package: a host without it still runs the encrypted transport. The
pure-Python ladder below is pinned to the RFC 7748 section 5.2/6.1 test
vectors (tests/test_secure_transport.py, incl. the 1000-iteration ladder
vector) and the native backend, when importable, is used opportunistically
AND cross-checked byte-for-byte as a parity oracle.

Backend selection: TENDERMINT_SECRETCONN_BACKEND = auto|pure|native
(auto = native when importable, else pure; `native` without the package
raises loudly at first use — an operator pinning a backend must not get a
silent fallback).

Side channels: Python big-int arithmetic is not constant-time, so neither
is this ladder (the cswap is data-dependent). That is the documented
trade: the keys exchanged here are EPHEMERAL per-connection handshake
keys (docs/secure-p2p.md threat model), and hosts wanting hardened
primitives install `cryptography` and get the OpenSSL path.

All integers little-endian per RFC 7748.
"""

from __future__ import annotations

import os

from tendermint_tpu_torch.libs.envknob import env_str

P = 2**255 - 19
_A24 = 121665
BASE_POINT = (9).to_bytes(32, "little")


class X25519Error(ValueError):
    """Malformed key bytes or an all-zero shared secret (low-order
    peer point — RFC 7748 section 6.1 MUST-check for this protocol)."""


def _decode_scalar(k: bytes) -> int:
    if len(k) != 32:
        raise X25519Error(f"x25519 scalar must be 32 bytes, got {len(k)}")
    a = bytearray(k)
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(a, "little")


def _decode_u(u: bytes) -> int:
    if len(u) != 32:
        raise X25519Error(f"x25519 point must be 32 bytes, got {len(u)}")
    # mask the high bit (RFC 7748 section 5: implementations MUST)
    return int.from_bytes(u, "little") & ((1 << 255) - 1)


def scalar_mult(k: bytes, u: bytes) -> bytes:
    """RFC 7748 section 5 X25519: Montgomery ladder over Curve25519.
    Returns the raw 32-byte u-coordinate (possibly all-zero — the
    protocol-level check lives in `x25519`)."""
    key = _decode_scalar(k)
    x1 = _decode_u(u)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        kt = (key >> t) & 1
        swap ^= kt
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        # one ladder step (RFC 7748 section 5 pseudocode)
        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = z3 * z3 % P
        z3 = z3 * x1 % P
        x2 = aa * bb % P
        z2 = e * (aa + _A24 * e) % P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, P - 2, P) % P
    return out.to_bytes(32, "little")


def x25519(k: bytes, u: bytes) -> bytes:
    """Diffie-Hellman shared secret; raises X25519Error on an all-zero
    result (peer sent a low-order point), matching the native backend's
    `exchange` behavior byte-for-byte."""
    out = scalar_mult(k, u)
    if out == b"\x00" * 32:
        raise X25519Error("x25519: all-zero shared secret (low-order point)")
    return out


def public_from_private(k: bytes) -> bytes:
    return scalar_mult(k, BASE_POINT)


# -- backend selection --------------------------------------------------------

from tendermint_tpu_torch.crypto import _openssl

try:  # pragma: no cover - env dependent
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey as _NativePriv,
        X25519PublicKey as _NativePub,
    )

    _HAVE_NATIVE = True
except ImportError:  # pragma: no cover - env dependent
    _HAVE_NATIVE = False


def have_native() -> bool:
    return _HAVE_NATIVE


def resolve_backend(knob: str = "TENDERMINT_SECRETCONN_BACKEND") -> str:
    """'pure', 'native' (the `cryptography` package) or 'openssl'
    (ctypes straight into libcrypto — crypto/_openssl.py) per the env
    knob, shared with the AEAD module. auto prefers native > openssl >
    pure; a PINNED backend that is unavailable raises — never a silent
    downgrade of an explicit operator choice."""
    choice = env_str(knob, "auto", allowed=("auto", "pure", "native", "openssl"))
    if choice == "native" and not _HAVE_NATIVE:
        raise RuntimeError(
            f"{knob}=native but the `cryptography` package is not importable"
        )
    if choice == "openssl" and not _openssl.available():
        raise RuntimeError(f"{knob}=openssl but no usable libcrypto was found")
    if choice == "auto":
        if _HAVE_NATIVE:
            return "native"
        return "openssl" if _openssl.available() else "pure"
    return choice


# -- key objects (the exact interface secret_connection.py consumes) ----------


class X25519PublicKey:
    __slots__ = ("_raw",)

    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise X25519Error(f"x25519 public key must be 32 bytes, got {len(raw)}")
        self._raw = bytes(raw)

    @classmethod
    def from_public_bytes(cls, raw: bytes) -> "X25519PublicKey":
        return cls(raw)

    def public_bytes_raw(self) -> bytes:
        return self._raw


class X25519PrivateKey:
    """Ephemeral handshake key. `backend` records which implementation
    serves `exchange` ('pure'|'native') — surfaced by the node log and
    the p2p_secretconn_* telemetry so an operator can see which path a
    box runs."""

    __slots__ = ("_raw", "backend")

    def __init__(self, raw: bytes, backend: str | None = None):
        if len(raw) != 32:
            raise X25519Error(f"x25519 private key must be 32 bytes, got {len(raw)}")
        self._raw = bytes(raw)
        self.backend = backend if backend is not None else resolve_backend()

    @classmethod
    def generate(cls, backend: str | None = None) -> "X25519PrivateKey":
        return cls(os.urandom(32), backend=backend)

    @classmethod
    def from_private_bytes(cls, raw: bytes, backend: str | None = None) -> "X25519PrivateKey":
        return cls(raw, backend=backend)

    def private_bytes_raw(self) -> bytes:
        return self._raw

    def public_key(self) -> X25519PublicKey:
        if self.backend == "native":
            priv = _NativePriv.from_private_bytes(self._raw)
            return X25519PublicKey(priv.public_key().public_bytes_raw())
        if self.backend == "openssl":
            return X25519PublicKey(_openssl.x25519_public(self._raw))
        return X25519PublicKey(public_from_private(self._raw))

    def exchange(self, peer: X25519PublicKey) -> bytes:
        if self.backend == "native":
            try:
                return _NativePriv.from_private_bytes(self._raw).exchange(
                    _NativePub.from_public_bytes(peer.public_bytes_raw())
                )
            except ValueError as exc:
                # OpenSSL raises on the all-zero shared secret; keep ONE
                # exception type across backends so callers triage alike
                raise X25519Error(str(exc)) from exc
        if self.backend == "openssl":
            out = _openssl.x25519_derive(self._raw, peer.public_bytes_raw())
            if out is None:
                raise X25519Error(
                    "x25519: all-zero shared secret (low-order point)"
                )
            return out
        return x25519(self._raw, peer.public_bytes_raw())
