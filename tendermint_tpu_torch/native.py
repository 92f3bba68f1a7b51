"""ctypes loader for the C++ host library in `native/` (shared with the JAX
package, which keeps its own loader).

The port uses its batch SHA512(R||A||M) mod L digests and batch point
decompression behind the verify marshal, the batch Ed25519 verifier behind
the gateway's CPU path, and its hash entries (batch SHA-256 and
RIPEMD-160, Merkle leaf hashes and roots) as the CPU floor of the `Hasher`
and of `merkle.simple.FlatTree`'s wide levels. Loading is lazy;
a missing or stale library is built with `make -C native` at first use.
On any failure callers take their pure-Python paths, as in the JAX
package: this is host code, not the device path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger("tendermint_tpu_torch.native")

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libtendermint_native.so")

_lib = None
_lib_mtx = threading.Lock()
_load_failed = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR], check=True, capture_output=True, timeout=300
        )
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        logger.warning("native build failed: %s", exc)
        return False


def _sources_newer_than_lib() -> bool:
    try:
        lib_mtime = os.path.getmtime(_LIB_PATH)
    except OSError:
        return True
    src_dir = os.path.join(_NATIVE_DIR, "src")
    return any(
        os.path.getmtime(os.path.join(src_dir, f)) > lib_mtime
        for f in os.listdir(src_dir)
    )


def get_lib():
    """The loaded library, building it if needed; None if unavailable."""
    global _lib, _load_failed
    with _lib_mtx:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        if _sources_newer_than_lib() and not _build():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as exc:
            logger.warning("native load failed: %s", exc)
            _load_failed = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64 = ctypes.c_int64
        lib.tm_sha256_batch.argtypes = [u8p, u64p, i64, u8p]
        lib.tm_ripemd160_batch.argtypes = [u8p, u64p, i64, u8p]
        lib.tm_merkle_leaf_hashes.argtypes = [u8p, u64p, i64, u8p]
        lib.tm_merkle_root.argtypes = [u8p, i64, u8p]
        lib.tm_ed25519_verify_batch.argtypes = [u8p, u8p, u8p, u64p, i64, u8p]
        lib.tm_ed25519_verify_batch_rlc.argtypes = [u8p, u8p, u8p, u64p, i64]
        lib.tm_ed25519_verify_batch_rlc.restype = ctypes.c_int
        lib.tm_ed25519_hram_batch.argtypes = [u8p, u8p, u8p, u64p, i64, u8p]
        lib.tm_ed25519_decompress_batch.argtypes = [u8p, i64, u8p, u8p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def ready() -> bool:
    """available() WITHOUT triggering a build: True only when the library
    is loaded or the built .so is current. Hot paths call this so a batch
    never waits behind a compiler run."""
    if _lib is not None:
        return True
    if _load_failed:
        return False
    if not _lib_mtx.acquire(blocking=False):
        return False  # another thread is building right now
    _lib_mtx.release()
    return os.path.exists(_LIB_PATH) and not _sources_newer_than_lib()


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_u64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _concat(msgs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(msgs) + 1, dtype=np.uint64)
    total = 0
    for i, m in enumerate(msgs):
        total += len(m)
        offsets[i + 1] = total
    data = np.frombuffer(b"".join(msgs), dtype=np.uint8) if total else np.zeros(1, np.uint8)
    return np.ascontiguousarray(data), offsets


def _digests(out: np.ndarray, width: int, n: int) -> list[bytes]:
    raw = out.tobytes()
    return [raw[width * i : width * i + width] for i in range(n)]


def sha256_batch(msgs: list[bytes]) -> list[bytes]:
    data, offsets = _concat(msgs)
    out = np.zeros(len(msgs) * 32, dtype=np.uint8)
    get_lib().tm_sha256_batch(_as_u8p(data), _as_u64p(offsets), len(msgs), _as_u8p(out))
    return _digests(out, 32, len(msgs))


def ripemd160_batch(msgs: list[bytes]) -> list[bytes]:
    """RIPEMD-160 per message; equal-length runs hash 16 at a time in
    AVX-512 lanes where the host has them (the part-set path)."""
    data, offsets = _concat(msgs)
    out = np.zeros(len(msgs) * 20, dtype=np.uint8)
    get_lib().tm_ripemd160_batch(_as_u8p(data), _as_u64p(offsets), len(msgs), _as_u8p(out))
    return _digests(out, 20, len(msgs))


def merkle_leaf_hashes(items: list[bytes]) -> list[bytes]:
    """merkle.simple.leaf_hash per item: RIPEMD-160 of the length-prefixed
    item."""
    data, offsets = _concat(items)
    out = np.zeros(len(items) * 20, dtype=np.uint8)
    get_lib().tm_merkle_leaf_hashes(_as_u8p(data), _as_u64p(offsets), len(items), _as_u8p(out))
    return _digests(out, 20, len(items))


def merkle_root_from_leaf_digests(digests: list[bytes]) -> bytes:
    if not digests:
        return b""
    leaves = np.ascontiguousarray(np.frombuffer(b"".join(digests), dtype=np.uint8))
    out = np.zeros(20, dtype=np.uint8)
    get_lib().tm_merkle_root(_as_u8p(leaves), len(digests), _as_u8p(out))
    return out.tobytes()


def merkle_root(items: list[bytes]) -> bytes:
    return merkle_root_from_leaf_digests(merkle_leaf_hashes(items))


RLC_MIN_BATCH = 32  # below this the MSM's fixed costs beat its savings


def ed25519_verify_batch(items: list[tuple[bytes, bytes, bytes]]) -> list[bool]:
    """(pubkey32, msg, sig64) triples -> per-item validity, with the
    semantics of crypto.ed25519.verify.

    Wide well-formed batches first try one random-linear-combination check
    (a single multi-scalar multiplication for the whole batch); a rejection
    runs the exact per-item verifier once, so every accepted lane was
    covered by an accepting combined equation or checked on its own."""
    lib = get_lib()
    n = len(items)
    pub_parts: list[bytes] = []
    sig_parts: list[bytes] = []
    msgs = []
    ok_shape = np.ones(n, dtype=bool)
    for i, (pub, msg, sig) in enumerate(items):
        if len(pub) != 32 or len(sig) != 64:
            ok_shape[i] = False
            pub_parts.append(b"\x00" * 32)
            sig_parts.append(b"\x00" * 64)
            msgs.append(b"")
            continue
        pub_parts.append(bytes(pub))
        sig_parts.append(bytes(sig))
        msgs.append(bytes(msg))
    pubs = np.frombuffer(b"".join(pub_parts), dtype=np.uint8)
    sigs = np.frombuffer(b"".join(sig_parts), dtype=np.uint8)
    data, offsets = _concat(msgs)
    out = np.zeros(n, dtype=np.uint8)
    if n >= RLC_MIN_BATCH and ok_shape.all() and lib.tm_ed25519_verify_batch_rlc(
        _as_u8p(pubs), _as_u8p(sigs), _as_u8p(data), _as_u64p(offsets), n
    ):
        return [True] * n
    lib.tm_ed25519_verify_batch(
        _as_u8p(pubs), _as_u8p(sigs), _as_u8p(data), _as_u64p(offsets), n,
        _as_u8p(out),
    )
    return [bool(o and s) for o, s in zip(out, ok_shape)]


def ed25519_hram_batch(
    sigs: np.ndarray, pubs: np.ndarray, msgs_data: np.ndarray,
    offsets: np.ndarray, n: int,
) -> np.ndarray:
    """h = SHA512(R || A || M) mod L per row -> (n, 32) uint8 LE.
    sigs: (n*64,) u8 contiguous; pubs: (n*32,) u8; msgs concatenated."""
    lib = get_lib()
    out = np.zeros(n * 32, dtype=np.uint8)
    lib.tm_ed25519_hram_batch(
        _as_u8p(sigs), _as_u8p(pubs), _as_u8p(msgs_data), _as_u64p(offsets), n,
        _as_u8p(out),
    )
    return out.reshape(n, 32)


def ed25519_decompress_batch(pubs: np.ndarray, n: int):
    """(n*32,) u8 compressed keys -> ((n, 64) u8 x||y LE, (n,) bool ok)."""
    lib = get_lib()
    xy = np.zeros(n * 64, dtype=np.uint8)
    ok = np.zeros(n, dtype=np.uint8)
    lib.tm_ed25519_decompress_batch(_as_u8p(pubs), n, _as_u8p(xy), _as_u8p(ok))
    return xy.reshape(n, 64), ok.astype(bool)
