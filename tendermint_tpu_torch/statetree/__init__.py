"""Authenticated app-state tree.

`VersionedTree` is the canonical app-state commitment: a persistent
(copy-on-write) merkleized treap over byte keys with O(log n) expected
insert/update/delete, one immutable root per committed height, and
membership/absence proofs whose pure verifier lives in
merkle/statetree_proof.py (light clients import only that). Dirty-node
recompute at commit batches through ops.gateway.Hasher: every wave of
32 or more preimages is one RIPEMD-160 batch (K1 on the card).
"""

from tendermint_tpu_torch.merkle.statetree_proof import TreeProof
from tendermint_tpu_torch.statetree.tree import VersionedTree

__all__ = ["TreeProof", "VersionedTree"]
