"""Ed25519 (RFC 8032) — pure-Python group arithmetic plus an OpenSSL-backed
fast path (the `cryptography` package) where it is importable.

The pure-Python half supplies the curve constants and point operations
the device kernel's tables are derived from, and serves as sign/verify
where `cryptography` is absent. All integers little-endian per RFC 8032.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493  # group order
D = (-121665 * pow(121666, P - 2, P)) % P  # edwards d
I_SQRT = pow(2, (P - 1) // 4, P)  # sqrt(-1)

_By = 4 * pow(5, P - 2, P) % P


def _recover_x(y: int, sign: int) -> int | None:
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        if sign:
            return None
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * I_SQRT % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


_Bx = _recover_x(_By, 0)
B = (_Bx, _By, 1, _Bx * _By % P)  # extended coords (X, Y, Z, T)
IDENT = (0, 1, 1, 0)


def point_add(p, q):
    """Extended-coordinates addition (complete formula, RFC 8032 5.1.4)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_double(p):
    """Dedicated doubling (RFC 8032 5.1.4, dbl-2008-hwcd)."""
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    bb = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = (a + bb) % P
    e = (h - (x1 + y1) * (x1 + y1)) % P
    g = (a - bb) % P
    f = (c + g) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def scalar_mult(s: int, p):
    q = IDENT
    while s > 0:
        if s & 1:
            q = point_add(q, p)
        p = point_double(p)
        s >>= 1
    return q


def point_equal(p, q) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def point_compress(p) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, P - 2, P)
    x, y = x * zinv % P, y * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def point_decompress(s: bytes):
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _sha512_int(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little")


def _secret_expand(secret: bytes):
    if len(secret) != 32:
        raise ValueError("bad secret length")
    h = hashlib.sha512(secret).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key_py(secret: bytes) -> bytes:
    a, _ = _secret_expand(secret)
    return point_compress(scalar_mult(a, B))


def sign_py(secret: bytes, msg: bytes) -> bytes:
    a, prefix = _secret_expand(secret)
    pub = point_compress(scalar_mult(a, B))
    r = _sha512_int(prefix, msg) % L
    big_r = point_compress(scalar_mult(r, B))
    h = _sha512_int(big_r, pub, msg) % L
    s = (r + h * a) % L
    return big_r + int.to_bytes(s, 32, "little")


def verify_py(pub: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != 64:
        return False
    a_pt = point_decompress(pub)
    if a_pt is None:
        return False
    r_pt = point_decompress(sig[:32])
    if r_pt is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    h = _sha512_int(sig[:32], pub, msg) % L
    # [s]B == R + [h]A
    lhs = scalar_mult(s, B)
    rhs = point_add(r_pt, scalar_mult(h, a_pt))
    return point_equal(lhs, rhs)


try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )

    _HAVE_OPENSSL = True
except ImportError:  # pragma: no cover - env dependent
    _HAVE_OPENSSL = False


def public_key(secret: bytes) -> bytes:
    if _HAVE_OPENSSL:
        priv = Ed25519PrivateKey.from_private_bytes(secret)
        return priv.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )
    return public_key_py(secret)


def sign(secret: bytes, msg: bytes) -> bytes:
    if _HAVE_OPENSSL:
        return Ed25519PrivateKey.from_private_bytes(secret).sign(msg)
    return sign_py(secret, msg)


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Single-signature CPU verify — the sequential baseline."""
    if _HAVE_OPENSSL:
        if len(sig) != 64 or len(pub) != 32:
            return False
        try:
            Ed25519PublicKey.from_public_bytes(pub).verify(sig, msg)
            return True
        except (InvalidSignature, ValueError):
            return False
    return verify_py(pub, msg, sig)
