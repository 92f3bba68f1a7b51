"""Transactions: raw bytes with Merkle hashing and inclusion proofs
(reference: types/tx.go). Tx is a plain `bytes` alias; helpers operate on
lists of them. The tree is the left-heavy (n+1)//2 split of
types/tx.go:33-46, built flat (merkle.simple.FlatTree), and the injected
batch hook (ops.gateway.Hasher.tx_merkle_root) hashes it on the card and
memoizes roots per tx set, so reproposals and re-validation of an
unchanged set never rehash."""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

from tendermint_tpu_torch.merkle.simple import (
    SimpleProof,
    leaf_hash,
    simple_hash_from_hashes,
    simple_proofs_from_hashes,
)

Tx = bytes


def tx_hash(tx: Tx) -> bytes:
    """Tx.Hash: hash of the length-prefixed tx bytes (types/tx.go:20-22)."""
    return leaf_hash(tx)


# Batched tx-tree hook: node assembly installs the hashing gateway
# (ops.gateway.Hasher.tx_merkle_root) so Data.hash and block validation
# ride the hash kernels; None means the host tree. The gateway keeps
# the tree's shape, so the hashes are identical either way.
_batch_tx_root = None


def set_batch_tx_root(fn) -> None:
    global _batch_tx_root
    _batch_tx_root = fn


def txs_hash(txs: list[Tx]) -> bytes:
    """Merkle root of tx hashes (types/tx.go:33-46). Empty list -> b""."""
    if _batch_tx_root is not None:
        return _batch_tx_root(list(txs))
    return simple_hash_from_hashes([tx_hash(tx) for tx in txs])


def txs_index(txs: list[Tx], tx: Tx) -> int:
    for i, t in enumerate(txs):
        if t == tx:
            return i
    return -1


def txs_index_by_hash(txs: list[Tx], h: bytes) -> int:
    for i, t in enumerate(txs):
        if tx_hash(t) == h:
            return i
    return -1


@dataclass
class TxProof:
    """Merkle inclusion proof for one tx (types/tx.go:92-113)."""

    index: int
    total: int
    root_hash: bytes
    data: Tx
    proof: SimpleProof = dc_field(default_factory=SimpleProof)

    def leaf_hash(self) -> bytes:
        return tx_hash(self.data)

    def validate(self, data_hash: bytes) -> str | None:
        """None if valid against data_hash; else an error string."""
        if data_hash != self.root_hash:
            return "proof matches different data hash"
        if not self.proof.verify(self.index, self.total, self.leaf_hash(), self.root_hash):
            return "proof is not internally consistent"
        return None

    def to_json(self):
        return {
            "index": self.index,
            "total": self.total,
            "root_hash": self.root_hash.hex().upper(),
            "data": self.data.hex().upper(),
            "proof": self.proof.to_json(),
        }

    @classmethod
    def from_json(cls, obj) -> "TxProof":
        return cls(
            obj["index"],
            obj["total"],
            bytes.fromhex(obj["root_hash"]),
            bytes.fromhex(obj["data"]),
            SimpleProof.from_json(obj["proof"]),
        )


def txs_proof(txs: list[Tx], i: int) -> TxProof:
    if i < 0 or i >= len(txs):
        raise IndexError("tx index out of range")
    root, proofs = simple_proofs_from_hashes([tx_hash(tx) for tx in txs])
    return TxProof(index=i, total=len(txs), root_hash=root, data=txs[i], proof=proofs[i])


@dataclass
class TxResult:
    """Execution result of one tx, as stored by the tx indexer
    (types/tx.go:118-123)."""

    height: int
    index: int
    tx: Tx
    result: Any  # abci.ResponseDeliverTx

    def to_json(self):
        return {
            "height": self.height,
            "index": self.index,
            "tx": self.tx.hex().upper(),
            "result": self.result.to_json() if self.result is not None else None,
        }
