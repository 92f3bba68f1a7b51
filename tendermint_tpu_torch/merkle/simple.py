"""Simple Merkle tree and SimpleProof (reference tmlibs/merkle,
docs/specification/merkle.rst): a compact binary tree over a static list
where an odd count gives the LEFT side the extra leaf (the split point is
(n+1)//2, types/tx.go:33-46). Hashes are RIPEMD-160 (20 bytes) over
length-prefixed operands, so leaf and inner domains cannot collide by
concatenation.

The tree builds flat: `_flat_shape(n)` is the tree's shape (which slots
combine into which), cached per leaf count, and `FlatTree` is one node
buffer (leaves 0..n-1, internal nodes n..2n-2 in postorder, root last)
whose proofs are (tree, leaf-index) views (`SharedProof`), not copied aunt
lists. The merkle tree kernel (ops/merkle.py, ops/csrc/merkle_tree.cu)
fills the same slots in the same order from `_flat_shape`, so a node
buffer built on the card stands in for a host build byte for byte
(`FlatTree.from_nodes`). The recursive construction stays as
`recursive_proofs_from_hashes`, the oracle the flat one is tested against.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

from tendermint_tpu_torch.codec.binary import encode_bytes, encode_string
from tendermint_tpu_torch.crypto.hashing import _RIPEMD_TEMPLATE, ripemd160


def leaf_hash(item: bytes) -> bytes:
    """SimpleHashFromBinary: hash of the length-prefixed item."""
    return ripemd160(encode_bytes(item))


def inner_hash(left: bytes, right: bytes) -> bytes:
    """SimpleHashFromTwoHashes."""
    return ripemd160(encode_bytes(left) + encode_bytes(right))


def kv_hash(key: str, value: bytes) -> bytes:
    """KVPair leaf (Header.hash / simple_hash_from_map,
    types/block.go:173-188)."""
    return ripemd160(encode_string(key) + encode_bytes(value))


# -- flat level-order tree ----------------------------------------------------

# 0x01 0x14: the varint length prefix of a 20-byte digest (encode_bytes)
_INNER_PREFIX = b"\x01\x14"

# a level at least this wide hashes in one native batch call; narrower
# levels copy a hashlib template per node (a ctypes call and its marshal
# cost more than they save below it)
_NATIVE_LEVEL_MIN = 64


@lru_cache(maxsize=256)
def _flat_shape(n: int):
    """(left, right, levels) for n >= 2 leaves.

    left[k]/right[k]: child slots of internal node n+k (postorder).
    levels: per height (bottom-up), a tuple of (out_slot, left_slot,
    right_slot); a node depends only on lower levels, so each level hashes
    as one batch."""
    left: list[int] = []
    right: list[int] = []
    heights: list[int] = []
    # iterative postorder of build(lo, hi): frame = [lo, hi, stage,
    # left_slot, left_height]; `ret` carries the just-built child up
    stack = [[0, n, 0, -1, 0]]
    ret, ret_h = -1, 0
    while stack:
        f = stack[-1]
        if f[1] - f[0] == 1:
            ret, ret_h = f[0], 0
            stack.pop()
            continue
        mid = f[0] + (f[1] - f[0] + 1) // 2
        if f[2] == 0:
            f[2] = 1
            stack.append([f[0], mid, 0, -1, 0])
        elif f[2] == 1:
            f[3], f[4], f[2] = ret, ret_h, 2
            stack.append([mid, f[1], 0, -1, 0])
        else:
            slot = n + len(left)
            left.append(f[3])
            right.append(ret)
            heights.append(max(f[4], ret_h) + 1)
            ret, ret_h = slot, heights[-1]
            stack.pop()
    by_height: dict[int, list[tuple[int, int, int]]] = {}
    for k, h in enumerate(heights):
        by_height.setdefault(h, []).append((n + k, left[k], right[k]))
    levels = tuple(tuple(by_height[h]) for h in sorted(by_height))
    return tuple(left), tuple(right), levels


def _build_nodes(hashes: list[bytes]) -> list[bytes]:
    """All 2n-1 node hashes (leaves + postorder internal) for n >= 2."""
    n = len(hashes)
    _, _, levels = _flat_shape(n)
    nodes: list[bytes] = list(hashes) + [b""] * (n - 1)
    pfx = _INNER_PREFIX
    if any(len(h) != 20 for h in hashes):
        # leaves of another width (simple_hash_from_hashes is public):
        # the same shape with their real varint prefixes; internal nodes
        # are always 20-byte digests, so only leaf operands differ
        for level in levels:
            for o, l, r in level:
                nodes[o] = inner_hash(nodes[l], nodes[r])
        return nodes
    if _RIPEMD_TEMPLATE is None:  # pragma: no cover - OpenSSL without ripemd160
        for level in levels:
            for o, l, r in level:
                nodes[o] = ripemd160(pfx + nodes[l] + pfx + nodes[r])
        return nodes
    template_copy = _RIPEMD_TEMPLATE.copy
    for level in levels:
        if len(level) >= _NATIVE_LEVEL_MIN:
            from tendermint_tpu_torch import native

            # ready(), not available(): a tree build on the block path
            # never waits behind a native build
            if native.ready():
                pre = [pfx + nodes[l] + pfx + nodes[r] for _, l, r in level]
                for (o, _, _), d in zip(level, native.ripemd160_batch(pre)):
                    nodes[o] = d
                continue
        for o, l, r in level:
            h = template_copy()
            h.update(pfx + nodes[l] + pfx + nodes[r])
            nodes[o] = h.digest()
    return nodes


class FlatTree:
    """The full simple-Merkle node buffer over n leaves: one flat array
    (leaves 0..n-1, internal nodes postorder, root last) that every proof
    references instead of carrying copied aunt lists."""

    __slots__ = ("n", "nodes")

    def __init__(self, n: int, nodes: list[bytes]):
        self.n = n
        self.nodes = nodes

    @classmethod
    def from_leaf_digests(cls, digests: list[bytes]) -> "FlatTree":
        n = len(digests)
        if n <= 1:
            return cls(n, list(digests))
        return cls(n, _build_nodes(list(digests)))

    @classmethod
    def from_nodes(cls, n: int, nodes: list[bytes]) -> "FlatTree":
        """Rehydrate from a node buffer computed elsewhere (the merkle
        tree kernel's): leaves first, then internal nodes in postorder.
        Checks the count only; digest parity is the producer's contract,
        which the tests hold it to."""
        want = max(2 * n - 1, n)
        if len(nodes) != want:
            raise ValueError(
                f"flat tree over {n} leaves needs {want} nodes, got {len(nodes)}"
            )
        return cls(n, list(nodes))

    def root(self) -> bytes:
        if self.n == 0:
            return b""
        return self.nodes[-1]

    def internal_nodes(self) -> list[bytes]:
        """The postorder internal-node hashes ([] for n <= 1)."""
        return self.nodes[self.n:]

    def aunts_for(self, index: int) -> list[bytes]:
        """Bottom-up aunt hashes for one leaf: an O(log n) descent over
        the shared buffer, references and never copies."""
        n = self.n
        if not 0 <= index < n:
            raise IndexError(f"leaf {index} out of range (n={n})")
        if n == 1:
            return []
        left, right, _ = _flat_shape(n)
        nodes = self.nodes
        aunts: list[bytes] = []
        slot, lo, hi = 2 * n - 2, 0, n
        while hi - lo > 1:
            mid = lo + (hi - lo + 1) // 2
            l, r = left[slot - n], right[slot - n]
            if index < mid:
                aunts.append(nodes[r])
                slot, hi = l, mid
            else:
                aunts.append(nodes[l])
                slot, lo = r, mid
        aunts.reverse()
        return aunts

    def proofs(self) -> list["SimpleProof"]:
        return [SharedProof(self, i) for i in range(self.n)]


def simple_hash_from_hashes(hashes: list[bytes]) -> bytes:
    n = len(hashes)
    if n == 0:
        return b""
    if n == 1:
        return hashes[0]
    return _build_nodes(list(hashes))[-1]


def simple_hash_from_byteslices(items: list[bytes]) -> bytes:
    return simple_hash_from_hashes([leaf_hash(it) for it in items])


def simple_hash_from_map(kvs: dict[str, bytes]) -> bytes:
    """Merkle root of a string-keyed map: KVPair leaves in sorted key order."""
    return simple_hash_from_hashes([kv_hash(k, kvs[k]) for k in sorted(kvs)])


@dataclass(eq=False)
class SimpleProof:
    """Inclusion proof: the aunt hashes bottom-up (reference
    tmlibs/merkle SimpleProof; verified per part at types/part_set.go:204)."""

    aunts: list[bytes] = field(default_factory=list)

    def __eq__(self, other):
        # by aunts, so an eager SimpleProof and a SharedProof view over the
        # same tree compare equal
        if not isinstance(other, SimpleProof):
            return NotImplemented
        return list(self.aunts) == list(other.aunts)

    def verify(self, index: int, total: int, leaf: bytes, root: bytes) -> bool:
        if index < 0 or total <= 0 or index >= total:
            return False
        computed = _compute_hash_from_aunts(index, total, leaf, list(self.aunts))
        return computed is not None and computed == root

    def to_json(self):
        return {"aunts": [a.hex().upper() for a in self.aunts]}

    @classmethod
    def from_json(cls, obj) -> "SimpleProof":
        aunts = obj.get("aunts") if isinstance(obj, dict) else None
        # 64 aunts = a 2^64-leaf tree: anything deeper is garbage; each aunt
        # is exactly one RIPEMD-160 digest (40 hex characters), since one of
        # another width can never verify
        if not isinstance(aunts, list) or len(aunts) > 64 or any(
            not isinstance(a, str) or len(a) != 40 for a in aunts
        ):
            raise ValueError("bad merkle proof aunts")
        return cls([bytes.fromhex(a) for a in aunts])


class SharedProof(SimpleProof):
    """SimpleProof as a (tree, leaf-index) view: the aunts materialize from
    the shared FlatTree buffer on first access, so n proofs are n small
    views, not n copied lists."""

    __slots__ = ("_tree", "_index", "_aunts")

    def __init__(self, tree: FlatTree, index: int):
        self._tree = tree
        self._index = index
        self._aunts: list[bytes] | None = None

    @property
    def aunts(self) -> list[bytes]:
        if self._aunts is None:
            self._aunts = self._tree.aunts_for(self._index)
        return self._aunts


def _compute_hash_from_aunts(
    index: int, total: int, leaf: bytes, aunts: list[bytes]
) -> bytes | None:
    if total == 1:
        if aunts:
            return None
        return leaf
    mid = (total + 1) // 2
    if not aunts:
        return None
    aunt = aunts[-1]
    rest = aunts[:-1]
    if index < mid:
        left = _compute_hash_from_aunts(index, mid, leaf, rest)
        if left is None:
            return None
        return inner_hash(left, aunt)
    right = _compute_hash_from_aunts(index - mid, total - mid, leaf, rest)
    if right is None:
        return None
    return inner_hash(aunt, right)


def simple_proofs_from_hashes(hashes: list[bytes]) -> tuple[bytes, list[SimpleProof]]:
    """Root and a proof per leaf (NewPartSetFromData builds these for every
    part, types/part_set.go:95-122): the flat tree's shared-aunt views,
    byte-identical to recursive_proofs_from_hashes."""
    tree = FlatTree.from_leaf_digests(hashes)
    if tree.n == 0:
        return b"", []
    if tree.n == 1:
        return tree.nodes[0], [SimpleProof()]
    return tree.root(), tree.proofs()


def flat_tree_from_leaf_digests(digests: list[bytes]) -> FlatTree:
    return FlatTree.from_leaf_digests(digests)


def recursive_proofs_from_hashes(
    hashes: list[bytes],
) -> tuple[bytes, list[SimpleProof]]:
    """The recursive construction, kept as the oracle for the flat tree."""
    n = len(hashes)
    proofs = [SimpleProof() for _ in range(n)]
    root = _recursive_build(hashes, list(range(n)), proofs)
    return root, proofs


def _recursive_build(
    hashes: list[bytes], idxs: list[int], proofs: list[SimpleProof]
) -> bytes:
    n = len(hashes)
    if n == 0:
        return b""
    if n == 1:
        return hashes[0]
    mid = (n + 1) // 2
    left = _recursive_build(hashes[:mid], idxs[:mid], proofs)
    right = _recursive_build(hashes[mid:], idxs[mid:], proofs)
    for i in idxs[:mid]:
        proofs[i].aunts.append(right)
    for i in idxs[mid:]:
        proofs[i].aunts.append(left)
    return inner_hash(left, right)


def simple_proofs_from_byteslices(items: list[bytes]) -> tuple[bytes, list[SimpleProof]]:
    return simple_proofs_from_hashes([leaf_hash(it) for it in items])
