"""SHA-256 / SHA-512 / RIPEMD-160 host hashing.

RIPEMD-160 is the Merkle/leaf/address hash of the reference era
(tmlibs/merkle SimpleHashFromBinary, types/validator.go:75-86). hashlib
provides it only when OpenSSL ships the legacy provider, so a pure-Python
version covers the rest.
"""

from __future__ import annotations

import hashlib
import struct


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


_K1 = (0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E)
_K2 = (0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000)

_R1 = (
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8],
    [3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12],
    [1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2],
    [4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13],
)
_R2 = (
    [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12],
    [6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2],
    [15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13],
    [8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14],
    [12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11],
)
_S1 = (
    [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8],
    [7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12],
    [11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5],
    [11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12],
    [9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6],
)
_S2 = (
    [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6],
    [9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11],
    [9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5],
    [15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8],
    [8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11],
)

_M32 = 0xFFFFFFFF


def _rol(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


def _f(j: int, x: int, y: int, z: int) -> int:
    if j == 0:
        return x ^ y ^ z
    if j == 1:
        return (x & y) | (~x & z) & _M32
    if j == 2:
        return (x | ~y & _M32) ^ z
    if j == 3:
        return (x & z) | (y & ~z & _M32)
    return x ^ (y | ~z & _M32)


def _ripemd160_py(data: bytes) -> bytes:
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    msg = bytearray(data)
    bitlen = len(data) * 8
    msg.append(0x80)
    while len(msg) % 64 != 56:
        msg.append(0)
    msg += struct.pack("<Q", bitlen)

    for off in range(0, len(msg), 64):
        x = struct.unpack("<16I", msg[off : off + 64])
        a1, b1, c1, d1, e1 = h
        a2, b2, c2, d2, e2 = h
        for rnd in range(5):
            for i in range(16):
                t = (a1 + _f(rnd, b1, c1, d1) + x[_R1[rnd][i]] + _K1[rnd]) & _M32
                t = (_rol(t, _S1[rnd][i]) + e1) & _M32
                a1, e1, d1, c1, b1 = e1, d1, _rol(c1, 10), b1, t
                t = (a2 + _f(4 - rnd, b2, c2, d2) + x[_R2[rnd][i]] + _K2[rnd]) & _M32
                t = (_rol(t, _S2[rnd][i]) + e2) & _M32
                a2, e2, d2, c2, b2 = e2, d2, _rol(c2, 10), b2, t
        t = (h[1] + c1 + d2) & _M32
        h[1] = (h[2] + d1 + e2) & _M32
        h[2] = (h[3] + e1 + a2) & _M32
        h[3] = (h[4] + a1 + b2) & _M32
        h[4] = (h[0] + b1 + c2) & _M32
        h[0] = t
    return struct.pack("<5I", *h)


try:
    _RIPEMD_TEMPLATE = hashlib.new("ripemd160", b"")
except ValueError:  # pragma: no cover - OpenSSL without the legacy provider
    _RIPEMD_TEMPLATE = None


def ripemd160(data: bytes) -> bytes:
    if _RIPEMD_TEMPLATE is not None:
        h = _RIPEMD_TEMPLATE.copy()
        h.update(data)
        return h.digest()
    return _ripemd160_py(data)
