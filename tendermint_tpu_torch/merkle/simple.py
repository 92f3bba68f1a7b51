"""Simple Merkle root over a static list (reference
docs/specification/merkle.rst): a compact binary tree where an odd count
gives the LEFT side the extra leaf — the split point is (n+1)//2. Hashes
are RIPEMD-160 over length-prefixed operands, so leaf and inner domains
cannot collide by concatenation.

The JAX package builds the same tree level by level over a flat node
buffer; this recursive form gives the same root and is all the port's
callers (validator-set and commit hashes) need.
"""

from __future__ import annotations

from tendermint_tpu_torch.codec.binary import encode_bytes
from tendermint_tpu_torch.crypto.hashing import ripemd160


def leaf_hash(item: bytes) -> bytes:
    """SimpleHashFromBinary: hash of the length-prefixed item."""
    return ripemd160(encode_bytes(item))


def inner_hash(left: bytes, right: bytes) -> bytes:
    """SimpleHashFromTwoHashes."""
    return ripemd160(encode_bytes(left) + encode_bytes(right))


def _root(hashes: list[bytes], lo: int, hi: int) -> bytes:
    if hi - lo == 1:
        return hashes[lo]
    mid = lo + (hi - lo + 1) // 2
    return inner_hash(_root(hashes, lo, mid), _root(hashes, mid, hi))


def simple_hash_from_hashes(hashes: list[bytes]) -> bytes:
    if not hashes:
        return b""
    return _root(hashes, 0, len(hashes))
