"""Pure verifier for authenticated state-tree proofs.

The app-state commitment (statetree/) is a *merkleized
canonical treap*: a binary search tree over byte keys whose shape is a
pure function of the key SET (every node's heap priority is derived from
its key), so replicas that built their state through different operation
histories — replay from genesis, restore from a full snapshot's sorted
map, a delta chain — land on byte-identical roots. This module is the
proof side only: given a root (the committed ``app_hash``), verify that
a key maps to a value (membership) or that a key is NOT in the tree
(absence) — with no dependency on the tree implementation, so light
clients (rpc/light.py verified_query) and the statesync delta restore
path import just this.

Hash domains (RIPEMD-160, length-prefixed operands via codec.binary so
field boundaries can't be shifted by concatenation games):

    value_hash(v)            = H(0x00 || encode_bytes(v))
    node_hash(k, vh, lh, rh) = H(0x01 || encode_bytes(k) ||
                                 encode_bytes(vh) ||
                                 encode_bytes(lh) || encode_bytes(rh))

where lh/rh are the child subtree hashes (b"" for an empty child) and
every node — interior or leaf — carries a key/value pair (a treap, not a
leaf-only tree). The empty tree's root is b"".

A proof is the search path for the queried key, bottom-up:

- membership: path[0] is the node holding the key (its value revealed);
  each higher step carries the node's (key, value_hash, left, right)
  with the child hash on the query's side equal to the hash computed so
  far. Soundness: the chain of node_hash recomputations binds the whole
  path into the root, and unique keys mean no second location can hash
  to the same root.
- absence: the same path shape, but NO step's key equals the query and
  the terminal step's child pointer ON THE QUERY'S SIDE is empty. The
  verifier re-derives each step's direction from the query key itself
  (query < step.key -> left), so the path is forced to be exactly the
  BST search path the honest tree would take — and that search dying in
  an empty child proves the key is nowhere in the tree.

Adversarial-shape note: treap depth is O(log n) in expectation; an
attacker grinding keys whose priorities follow key order can deepen one
search path (cost ~O(depth^2) hash grinding). Proofs just grow with
depth; MAX_PROOF_STEPS bounds what a verifier will even decode.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.codec.binary import encode_bytes
from tendermint_tpu_torch.crypto.hashing import ripemd160

# the empty tree / empty child commitment
EMPTY_HASH = b""

# decode-time ceilings against garbage proofs: 512 steps is a tree an
# attacker ground ~2^18 hashes per level to build — anything deeper is
# garbage, not state. Keys/values bounded like tx payloads.
MAX_PROOF_STEPS = 512
MAX_KEY_BYTES = 1 << 16
MAX_VALUE_BYTES = 1 << 22

_LEAF_PREFIX = b"\x00"
_NODE_PREFIX = b"\x01"
_PRIO_PREFIX = b"\x02"


def value_hash(value: bytes) -> bytes:
    return ripemd160(_LEAF_PREFIX + encode_bytes(value))


def node_hash(key: bytes, vh: bytes, left: bytes, right: bytes) -> bytes:
    return ripemd160(
        _NODE_PREFIX
        + encode_bytes(key)
        + encode_bytes(vh)
        + encode_bytes(left)
        + encode_bytes(right)
    )


def key_priority(key: bytes) -> bytes:
    """The canonical heap priority of a key (compared as raw bytes,
    larger = closer to the root). Deriving it from the key alone is what
    makes the tree shape history-independent."""
    return ripemd160(_PRIO_PREFIX + key)


@dataclass
class ProofStep:
    """One node on the search path: its key, its value's hash, and both
    child subtree hashes (EMPTY_HASH for an absent child)."""

    key: bytes
    vh: bytes
    left: bytes
    right: bytes

    def hash(self) -> bytes:
        return node_hash(self.key, self.vh, self.left, self.right)

    def to_json(self) -> list:
        return [
            self.key.hex().upper(),
            self.vh.hex().upper(),
            self.left.hex().upper(),
            self.right.hex().upper(),
        ]

    @classmethod
    def from_json(cls, obj) -> "ProofStep":
        if not isinstance(obj, list) or len(obj) != 4 or any(
            not isinstance(x, str) for x in obj
        ):
            raise ValueError("bad proof step")
        key, vh, left, right = (bytes.fromhex(x) for x in obj)
        if len(key) > MAX_KEY_BYTES:
            raise ValueError("proof step key too long")
        if len(vh) != 20:
            raise ValueError("proof step value hash must be 20 bytes")
        for child in (left, right):
            if child != EMPTY_HASH and len(child) != 20:
                raise ValueError("proof step child hash must be 0 or 20 bytes")
        return cls(key, vh, left, right)


@dataclass
class TreeProof:
    """Membership (value is bytes) or absence (value is None) proof for
    `key`, as the bottom-up search path `steps` (terminal node first,
    root last). Verification is pure: `verify(root)` needs only this
    object and the trusted root."""

    key: bytes
    value: bytes | None
    steps: list[ProofStep]

    @property
    def is_membership(self) -> bool:
        return self.value is not None

    def verify(self, root: bytes) -> bool:
        key = self.key
        steps = self.steps
        if not steps:
            # only the EMPTY tree has an empty search path, and it can
            # only prove absence
            return self.value is None and root == EMPTY_HASH
        term = steps[0]
        if self.value is not None:
            # membership: the terminal node must BE the entry
            if term.key != key or term.vh != value_hash(self.value):
                return False
        else:
            # absence: the search must die in an empty child at the
            # terminal node, and no step on the path may hold the key
            if term.key == key:
                return False
            side = term.left if key < term.key else term.right
            if side != EMPTY_HASH:
                return False
        h = term.hash()
        for step in steps[1:]:
            if step.key == key:
                # the query key at an interior step: for absence this is
                # a contradiction; for membership it would mean the key
                # appears twice — honest trees have unique keys
                return False
            # re-derive the direction from the QUERY key: this forces
            # the path to be the tree's actual search path for `key`
            expected = step.left if key < step.key else step.right
            if expected != h:
                return False
            h = step.hash()
        return h == root

    def to_json(self) -> dict:
        out = {
            "key": self.key.hex().upper(),
            "steps": [s.to_json() for s in self.steps],
        }
        if self.value is not None:
            out["value"] = self.value.hex().upper()
        return out

    @classmethod
    def from_json(cls, obj) -> "TreeProof":
        """Decode an UNTRUSTED proof; every violation raises ValueError
        (the peer-error / RPC-error alphabet)."""
        if not isinstance(obj, dict):
            raise ValueError("tree proof must be an object")
        key_hex = obj.get("key")
        if not isinstance(key_hex, str) or len(key_hex) > 2 * MAX_KEY_BYTES:
            raise ValueError("bad tree proof key")
        value = None
        if "value" in obj:
            value_hex = obj["value"]
            if not isinstance(value_hex, str) or len(value_hex) > 2 * MAX_VALUE_BYTES:
                raise ValueError("bad tree proof value")
            value = bytes.fromhex(value_hex)
        raw_steps = obj.get("steps")
        if not isinstance(raw_steps, list) or len(raw_steps) > MAX_PROOF_STEPS:
            raise ValueError("bad tree proof steps")
        return cls(
            bytes.fromhex(key_hex),
            value,
            [ProofStep.from_json(s) for s in raw_steps],
        )
