"""secp256k1 ECDSA keys, the second key type (reference usage:
types/validator.go:75-86 — any crypto.PubKey can be a validator key).

Pure Python: Jacobian point math, RFC 6979 deterministic nonces, strict
minimal DER and low-s refusal. The JAX package's module also has an
opportunistic `cryptography` (OpenSSL) branch; the port leaves it out:
the card's machine has no such package, and the verdicts are the same
either way (its signer's random nonces give other bytes, but they verify
here, and these signatures verify there). Wire shapes:

- private key: the 32-byte big-endian scalar;
- public key: the 33-byte compressed SEC1 point;
- signature: DER ECDSA over SHA-256 of the message (variable length,
  about 70-72 bytes), low-s, so a stored signature cannot be malleated
  into another valid one.

secp256k1 stays a CPU key type: the gateway splits batches by key type
and verifies these lanes here, counted in `cpu_sigs`. The arithmetic is
not constant-time (Python integers).
"""

from __future__ import annotations

import hashlib
import hmac
import os

# -- curve constants (SEC2 2.4.1) -------------------------------------------

_P = 2**256 - 2**32 - 977
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
_B = 7

_INF = (0, 1, 0)  # Jacobian point at infinity (Z == 0)
_G = (_GX, _GY, 1)


def gen_secret() -> bytes:
    """A uniformly random 32-byte scalar in [1, n-1]."""
    while True:
        d = int.from_bytes(os.urandom(32), "big")
        if 1 <= d < _N:
            return d.to_bytes(32, "big")


def secret_from_seed(seed: bytes) -> bytes:
    """Deterministic scalar from secret material: sha256, re-hashed on the
    negligible out-of-range case."""
    d = seed
    while True:
        d = hashlib.sha256(d).digest()
        if 1 <= int.from_bytes(d, "big") < _N:
            return d


# -- Jacobian point arithmetic (y^2 = x^3 + 7, a = 0) -------------------------


def _jdouble(pt):
    x1, y1, z1 = pt
    if z1 == 0 or y1 == 0:
        return _INF
    a = x1 * x1 % _P
    b = y1 * y1 % _P
    c = b * b % _P
    d = 2 * ((x1 + b) * (x1 + b) - a - c) % _P
    e = 3 * a % _P
    x3 = (e * e - 2 * d) % _P
    y3 = (e * (d - x3) - 8 * c) % _P
    z3 = 2 * y1 * z1 % _P
    return (x3, y3, z3)


def _jadd(p1, p2):
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if z1 == 0:
        return p2
    if z2 == 0:
        return p1
    z1z1 = z1 * z1 % _P
    z2z2 = z2 * z2 % _P
    u1 = x1 * z2z2 % _P
    u2 = x2 * z1z1 % _P
    s1 = y1 * z2 * z2z2 % _P
    s2 = y2 * z1 * z1z1 % _P
    if u1 == u2:
        if s1 != s2:
            return _INF
        return _jdouble(p1)
    h = (u2 - u1) % _P
    r = (s2 - s1) % _P
    hh = h * h % _P
    hhh = h * hh % _P
    v = u1 * hh % _P
    x3 = (r * r - hhh - 2 * v) % _P
    y3 = (r * (v - x3) - s1 * hhh) % _P
    z3 = z1 * z2 % _P * h % _P
    return (x3, y3, z3)


def _jmul(k: int, pt):
    q = _INF
    while k > 0:
        if k & 1:
            q = _jadd(q, pt)
        pt = _jdouble(pt)
        k >>= 1
    return q


def _to_affine(pt):
    x, y, z = pt
    if z == 0:
        return None
    zi = pow(z, _P - 2, _P)
    zi2 = zi * zi % _P
    return (x * zi2 % _P, y * zi2 % _P * zi % _P)


def _decompress(pub33: bytes):
    """Affine point from a 33-byte compressed SEC1 encoding, or None."""
    if len(pub33) != 33 or pub33[0] not in (2, 3):
        return None
    x = int.from_bytes(pub33[1:], "big")
    if x >= _P:
        return None
    y2 = (x * x % _P * x + _B) % _P
    y = pow(y2, (_P + 1) // 4, _P)  # p == 3 (mod 4)
    if y * y % _P != y2:
        return None  # not on the curve
    if (y & 1) != (pub33[0] & 1):
        y = _P - y
    return (x, y)


def _compress(x: int, y: int) -> bytes:
    return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")


# -- DER (ASN.1 SEQUENCE of two INTEGERs, strict minimal encoding) ------------


def encode_der(r: int, s: int) -> bytes:
    def enc_int(v: int) -> bytes:
        raw = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
        if raw[0] & 0x80:
            raw = b"\x00" + raw
        return b"\x02" + bytes([len(raw)]) + raw

    body = enc_int(r) + enc_int(s)
    if len(body) > 0x7F:
        raise ValueError("DER signature body too long")
    return b"\x30" + bytes([len(body)]) + body


def decode_der(sig: bytes) -> tuple[int, int]:
    """(r, s) from a strict minimal DER ECDSA signature; raises ValueError
    on any malformation (trailing bytes, padded or negative integers,
    long-form lengths a 72-byte signature never needs)."""

    def dec_int(buf: bytes, off: int) -> tuple[int, int]:
        if off + 2 > len(buf) or buf[off] != 0x02:
            raise ValueError("DER: expected INTEGER")
        ln = buf[off + 1]
        if ln & 0x80 or ln == 0 or off + 2 + ln > len(buf):
            raise ValueError("DER: bad integer length")
        raw = buf[off + 2 : off + 2 + ln]
        if raw[0] & 0x80:
            raise ValueError("DER: negative integer")
        if ln > 1 and raw[0] == 0 and not raw[1] & 0x80:
            raise ValueError("DER: non-minimal integer")
        return int.from_bytes(raw, "big"), off + 2 + ln

    if len(sig) < 8 or sig[0] != 0x30:
        raise ValueError("DER: expected SEQUENCE")
    if sig[1] & 0x80 or sig[1] != len(sig) - 2:
        raise ValueError("DER: bad sequence length")
    r, off = dec_int(sig, 2)
    s, off = dec_int(sig, off)
    if off != len(sig):
        raise ValueError("DER: trailing bytes")
    return r, s


# -- RFC 6979 deterministic nonce ---------------------------------------------


def _rfc6979_k(secret: bytes, e: int):
    """Candidate nonces for (key, digest) per RFC 6979 section 3.2."""
    h1 = (e % _N).to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + secret + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + secret + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        yield int.from_bytes(v, "big")
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


# -- ECDSA --------------------------------------------------------------------


def _digest_int(msg: bytes) -> int:
    return int.from_bytes(hashlib.sha256(msg).digest(), "big")


def public_key(secret32: bytes) -> bytes:
    """33-byte compressed SEC1 public point."""
    d = int.from_bytes(secret32, "big")
    if not 1 <= d < _N:
        raise ValueError("secp256k1 secret out of range")
    x, y = _to_affine(_jmul(d, _G))
    return _compress(x, y)


def sign(secret32: bytes, msg: bytes) -> bytes:
    """DER ECDSA-SHA256 signature with an RFC 6979 nonce, low-s."""
    d = int.from_bytes(secret32, "big")
    if not 1 <= d < _N:
        raise ValueError("secp256k1 secret out of range")
    e = _digest_int(msg)
    for k in _rfc6979_k(secret32, e):
        if not 1 <= k < _N:
            continue
        pt = _to_affine(_jmul(k, _G))
        if pt is None:
            continue
        r = pt[0] % _N
        if r == 0:
            continue
        s = pow(k, _N - 2, _N) * (e + r * d) % _N
        if s == 0:
            continue
        if s > _N // 2:
            s = _N - s
        return encode_der(r, s)


def verify(pub33: bytes, msg: bytes, sig_der: bytes) -> bool:
    q = _decompress(pub33)
    if q is None:
        return False
    try:
        r, s = decode_der(sig_der)
    except ValueError:
        return False
    if not (1 <= r < _N and 1 <= s <= _N // 2):
        return False  # reject high-s (malleability) and degenerate sigs
    e = _digest_int(msg)
    si = pow(s, _N - 2, _N)
    u1 = e * si % _N
    u2 = r * si % _N
    pt = _to_affine(_jadd(_jmul(u1, _G), _jmul(u2, (q[0], q[1], 1))))
    if pt is None:
        return False
    return pt[0] % _N == r
