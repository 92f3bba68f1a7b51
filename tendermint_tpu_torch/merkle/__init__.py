"""Simple Merkle roots (tmlibs/merkle equivalent)."""

from tendermint_tpu_torch.merkle.simple import (
    SimpleProof,
    inner_hash,
    leaf_hash,
    simple_hash_from_byteslices,
    simple_hash_from_hashes,
    simple_hash_from_map,
    simple_proofs_from_byteslices,
    simple_proofs_from_hashes,
)

__all__ = [
    "SimpleProof",
    "leaf_hash",
    "inner_hash",
    "simple_hash_from_hashes",
    "simple_hash_from_byteslices",
    "simple_hash_from_map",
    "simple_proofs_from_hashes",
    "simple_proofs_from_byteslices",
]
