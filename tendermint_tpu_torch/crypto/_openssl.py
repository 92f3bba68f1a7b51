"""ctypes bindings to the system libcrypto (OpenSSL >= 1.1.1) for the
SecretConnection primitives — an opportunistic fast path that needs NO
third-party Python package: a host without `cryptography` usually
still ships libcrypto.so, and per-frame AEAD in pure Python costs ~1 ms
while EVP does it in ~10 us. Everything here is optional: `available()`
is False when the library (or any needed symbol) is missing, and the
callers (crypto/x25519.py, crypto/chacha20poly1305.py) fall back to the
RFC-vector-pinned pure-Python implementations, which also serve as the
parity oracle for these bindings (tests/test_secure_transport.py
cross-checks byte-for-byte).

Scope is deliberately tiny — exactly the two primitives the transport
needs: ChaCha20-Poly1305 seal/open via the EVP AEAD interface, and
X25519 keygen/derive via the raw-key EVP_PKEY interface. Every call
allocates its own ctx and frees it in a finally block (OpenSSL >= 1.1 is
thread-safe with per-call contexts)."""

from __future__ import annotations

import ctypes
import ctypes.util

_EVP_CTRL_AEAD_SET_IVLEN = 0x09
_EVP_CTRL_AEAD_GET_TAG = 0x10
_EVP_CTRL_AEAD_SET_TAG = 0x11
_NID_X25519 = 1034
TAG_LEN = 16

_SYMS = (
    "EVP_chacha20_poly1305",
    "EVP_CIPHER_CTX_new",
    "EVP_CIPHER_CTX_free",
    "EVP_CIPHER_CTX_ctrl",
    "EVP_EncryptInit_ex",
    "EVP_EncryptUpdate",
    "EVP_EncryptFinal_ex",
    "EVP_DecryptInit_ex",
    "EVP_DecryptUpdate",
    "EVP_DecryptFinal_ex",
    "EVP_PKEY_new_raw_private_key",
    "EVP_PKEY_new_raw_public_key",
    "EVP_PKEY_get_raw_public_key",
    "EVP_PKEY_free",
    "EVP_PKEY_CTX_new",
    "EVP_PKEY_CTX_free",
    "EVP_PKEY_derive_init",
    "EVP_PKEY_derive_set_peer",
    "EVP_PKEY_derive",
)


def _load():
    name = ctypes.util.find_library("crypto")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    if any(not hasattr(lib, s) for s in _SYMS):
        return None
    p, i, cp = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    ip = ctypes.POINTER(ctypes.c_int)
    sp = ctypes.POINTER(ctypes.c_size_t)
    # declare every signature explicitly: on LP64 a defaulted int return
    # truncates pointers, which is exactly the kind of silent corruption
    # a crypto binding cannot have
    lib.EVP_chacha20_poly1305.restype = p
    lib.EVP_chacha20_poly1305.argtypes = ()
    lib.EVP_CIPHER_CTX_new.restype = p
    lib.EVP_CIPHER_CTX_new.argtypes = ()
    lib.EVP_CIPHER_CTX_free.restype = None
    lib.EVP_CIPHER_CTX_free.argtypes = (p,)
    lib.EVP_CIPHER_CTX_ctrl.restype = i
    lib.EVP_CIPHER_CTX_ctrl.argtypes = (p, i, i, p)
    for fn in (lib.EVP_EncryptInit_ex, lib.EVP_DecryptInit_ex):
        fn.restype = i
        fn.argtypes = (p, p, p, cp, cp)
    for fn in (lib.EVP_EncryptUpdate, lib.EVP_DecryptUpdate):
        fn.restype = i
        fn.argtypes = (p, cp, ip, cp, i)
    for fn in (lib.EVP_EncryptFinal_ex, lib.EVP_DecryptFinal_ex):
        fn.restype = i
        fn.argtypes = (p, cp, ip)
    lib.EVP_PKEY_new_raw_private_key.restype = p
    lib.EVP_PKEY_new_raw_private_key.argtypes = (i, p, cp, ctypes.c_size_t)
    lib.EVP_PKEY_new_raw_public_key.restype = p
    lib.EVP_PKEY_new_raw_public_key.argtypes = (i, p, cp, ctypes.c_size_t)
    lib.EVP_PKEY_get_raw_public_key.restype = i
    lib.EVP_PKEY_get_raw_public_key.argtypes = (p, cp, sp)
    lib.EVP_PKEY_free.restype = None
    lib.EVP_PKEY_free.argtypes = (p,)
    lib.EVP_PKEY_CTX_new.restype = p
    lib.EVP_PKEY_CTX_new.argtypes = (p, p)
    lib.EVP_PKEY_CTX_free.restype = None
    lib.EVP_PKEY_CTX_free.argtypes = (p,)
    lib.EVP_PKEY_derive_init.restype = i
    lib.EVP_PKEY_derive_init.argtypes = (p,)
    lib.EVP_PKEY_derive_set_peer.restype = i
    lib.EVP_PKEY_derive_set_peer.argtypes = (p, p)
    lib.EVP_PKEY_derive.restype = i
    lib.EVP_PKEY_derive.argtypes = (p, cp, sp)
    return lib


_LIB = _load()


def available() -> bool:
    return _LIB is not None


class OpenSSLError(RuntimeError):
    """An EVP call failed where the inputs were valid — misuse or a
    broken library, never a routine condition (tag mismatch returns a
    status, not this)."""


# -- ChaCha20-Poly1305 --------------------------------------------------------


def aead_seal(key: bytes, nonce: bytes, plaintext: bytes, aad: bytes) -> bytes:
    lib = _LIB
    outl = ctypes.c_int(0)
    out = ctypes.create_string_buffer(len(plaintext) + TAG_LEN)
    ctx = lib.EVP_CIPHER_CTX_new()
    if not ctx:
        raise OpenSSLError("EVP_CIPHER_CTX_new failed")
    try:
        ok = lib.EVP_EncryptInit_ex(ctx, lib.EVP_chacha20_poly1305(), None, None, None)
        ok &= lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_AEAD_SET_IVLEN, len(nonce), None)
        ok &= lib.EVP_EncryptInit_ex(ctx, None, None, key, nonce)
        if ok and aad:
            ok &= lib.EVP_EncryptUpdate(ctx, None, ctypes.byref(outl), aad, len(aad))
        n = 0
        if ok and plaintext:
            ok &= lib.EVP_EncryptUpdate(
                ctx, out, ctypes.byref(outl), plaintext, len(plaintext)
            )
            n = outl.value
        if ok:
            ok &= lib.EVP_EncryptFinal_ex(
                ctx, ctypes.cast(ctypes.byref(out, n), ctypes.c_char_p),
                ctypes.byref(outl),
            )
            n += outl.value
        tag = ctypes.create_string_buffer(TAG_LEN)
        if ok:
            ok &= lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_AEAD_GET_TAG, TAG_LEN, tag)
        if not ok or n != len(plaintext):
            raise OpenSSLError("chacha20-poly1305 seal failed")
        return out.raw[:n] + tag.raw
    finally:
        lib.EVP_CIPHER_CTX_free(ctx)


def aead_open(key: bytes, nonce: bytes, boxed: bytes, aad: bytes) -> bytes | None:
    """Plaintext, or None on authentication failure (the caller owns the
    exception type so triage is backend-independent)."""
    if len(boxed) < TAG_LEN:
        return None
    ct, tag = boxed[:-TAG_LEN], boxed[-TAG_LEN:]
    lib = _LIB
    outl = ctypes.c_int(0)
    out = ctypes.create_string_buffer(max(1, len(ct)))
    ctx = lib.EVP_CIPHER_CTX_new()
    if not ctx:
        raise OpenSSLError("EVP_CIPHER_CTX_new failed")
    try:
        ok = lib.EVP_DecryptInit_ex(ctx, lib.EVP_chacha20_poly1305(), None, None, None)
        ok &= lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_AEAD_SET_IVLEN, len(nonce), None)
        ok &= lib.EVP_DecryptInit_ex(ctx, None, None, key, nonce)
        if ok and aad:
            ok &= lib.EVP_DecryptUpdate(ctx, None, ctypes.byref(outl), aad, len(aad))
        n = 0
        if ok and ct:
            ok &= lib.EVP_DecryptUpdate(ctx, out, ctypes.byref(outl), ct, len(ct))
            n = outl.value
        if ok:
            ok &= lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_AEAD_SET_TAG, TAG_LEN, tag)
        if not ok:
            raise OpenSSLError("chacha20-poly1305 open setup failed")
        # final returns 0 on tag mismatch — the one ROUTINE failure here
        if not lib.EVP_DecryptFinal_ex(
            ctx, ctypes.cast(ctypes.byref(out, n), ctypes.c_char_p),
            ctypes.byref(outl),
        ):
            return None
        return out.raw[: n + outl.value]
    finally:
        lib.EVP_CIPHER_CTX_free(ctx)


# -- X25519 -------------------------------------------------------------------


def x25519_public(priv: bytes) -> bytes:
    lib = _LIB
    pkey = lib.EVP_PKEY_new_raw_private_key(_NID_X25519, None, priv, len(priv))
    if not pkey:
        raise OpenSSLError("X25519 private key rejected")
    try:
        n = ctypes.c_size_t(32)
        buf = ctypes.create_string_buffer(32)
        if not lib.EVP_PKEY_get_raw_public_key(pkey, buf, ctypes.byref(n)):
            raise OpenSSLError("X25519 public key extraction failed")
        return buf.raw[: n.value]
    finally:
        lib.EVP_PKEY_free(pkey)


def x25519_derive(priv: bytes, peer_pub: bytes) -> bytes | None:
    """Shared secret, or None when libcrypto rejects the exchange (it
    refuses low-order peer points with an all-zero output itself)."""
    lib = _LIB
    pkey = lib.EVP_PKEY_new_raw_private_key(_NID_X25519, None, priv, len(priv))
    if not pkey:
        raise OpenSSLError("X25519 private key rejected")
    peer = None
    pctx = None
    try:
        peer = lib.EVP_PKEY_new_raw_public_key(_NID_X25519, None, peer_pub, len(peer_pub))
        if not peer:
            return None
        pctx = lib.EVP_PKEY_CTX_new(pkey, None)
        if not pctx:
            raise OpenSSLError("EVP_PKEY_CTX_new failed")
        if not lib.EVP_PKEY_derive_init(pctx):
            raise OpenSSLError("EVP_PKEY_derive_init failed")
        if not lib.EVP_PKEY_derive_set_peer(pctx, peer):
            return None
        n = ctypes.c_size_t(32)
        buf = ctypes.create_string_buffer(32)
        if not lib.EVP_PKEY_derive(pctx, buf, ctypes.byref(n)):
            return None
        return buf.raw[: n.value]
    finally:
        if pctx:
            lib.EVP_PKEY_CTX_free(pctx)
        if peer:
            lib.EVP_PKEY_free(peer)
        lib.EVP_PKEY_free(pkey)
