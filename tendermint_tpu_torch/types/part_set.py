"""PartSet: a block split into fixed-size parts, each carrying a Merkle
inclusion proof so peers can forward parts before holding the whole block
(reference: types/part_set.go; spec docs/specification/block-structure.rst
"PartSet").

Part hashing (RIPEMD-160 of each 64 KB part, types/part_set.go:32-41) and
proof building (NewPartSetFromData, types/part_set.go:95-122) are the
hash plane's main path: with the gateway's Hasher wired in they run on
the card (ops/merkle.py). A part's leaf hash is the raw RIPEMD-160 of its
bytes, not length-prefixed, as Part.Hash.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field as dc_field

from tendermint_tpu_torch.codec import jsonval as jv
from tendermint_tpu_torch.crypto.hashing import ripemd160
from tendermint_tpu_torch.libs.bitarray import BitArray
from tendermint_tpu_torch.merkle.simple import SimpleProof, simple_proofs_from_hashes
from tendermint_tpu_torch.types.block_id import PartSetHeader


class PartSetError(Exception):
    pass


class UnexpectedIndexError(PartSetError):
    pass


class InvalidProofError(PartSetError):
    pass


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: SimpleProof = dc_field(default_factory=SimpleProof)
    _hash: bytes | None = None

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = ripemd160(self.bytes_)
        return self._hash

    def to_json(self):
        return {
            "index": self.index,
            "bytes": self.bytes_.hex().upper(),
            "proof": self.proof.to_json(),
        }

    @classmethod
    def from_json(cls, obj) -> "Part":
        return cls(
            jv.int_field(obj, "index", 0, jv.MAX_INDEX),
            # parts are 64 KB on the wire; 1 MB is protocol slack, the real
            # cap is the channel's receive capacity
            jv.hex_field(obj, "bytes", max_bytes=1 << 20),
            SimpleProof.from_json(jv.dict_field(obj, "proof")),
        )


class PartSet:
    """Thread-safe; the reference's two constructors: from full data
    (immutable, complete) or from a header (empty, filled by add_part)."""

    def __init__(self, total: int, hash_: bytes):
        self._total = total
        self._hash = hash_
        self._mtx = threading.Lock()
        self._parts: list[Part | None] = [None] * total
        self._bit_array = BitArray(total)
        self._count = 0

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_data(
        cls, data: bytes, part_size: int, hasher=None, tree_hasher=None,
        tree_submitter=None,
    ) -> "PartSet":
        """Split and build the Merkle proofs (NewPartSetFromData,
        types/part_set.go:95-122). `hasher` optionally supplies batched
        leaf hashes, equal to [ripemd160(p) for p in chunks].
        `tree_hasher` (ops.gateway.Hasher.part_set_tree) optionally
        supplies (leaf hashes, merkle.simple.FlatTree) from one device
        pass, which makes the proofs free here; None falls through to the
        host path. `tree_submitter` (Hasher.submit_part_set_tree) is its
        future form: the chunks hash on the card while this thread builds
        the parts, and the future is joined for the proofs. Either way the
        proofs are shared-aunt views over one flat node buffer,
        byte-identical to the recursive reference.

        Unlike the JAX package, a submission or tree build that fails
        raises here: nothing falls through to the CPU."""
        total = max((len(data) + part_size - 1) // part_size, 1)
        chunks = [data[i * part_size : (i + 1) * part_size] for i in range(total)]
        leaf_hashes = tree = None
        if tree_submitter is not None:
            fut = tree_submitter(chunks)
            # host work that overlaps the device's: the parts
            shell_parts = [Part(index=i, bytes_=c) for i, c in enumerate(chunks)]
            built = fut.result(timeout=120)
            if built is not None:
                leaf_hashes, tree = built
                root, proofs = tree.root(), tree.proofs()
                ps = cls(total, root)
                for i, part in enumerate(shell_parts):
                    part.proof = proofs[i]
                    part._hash = leaf_hashes[i]
                    ps._parts[i] = part
                    ps._bit_array.set_index(i, True)
                ps._count = total
                return ps
        if tree_hasher is not None:
            built = tree_hasher(chunks)
            if built is not None:
                leaf_hashes, tree = built
        if leaf_hashes is None:
            if hasher is not None:
                leaf_hashes = hasher(chunks)
            else:
                leaf_hashes = [ripemd160(c) for c in chunks]
        if tree is not None:
            root, proofs = tree.root(), tree.proofs()
        else:
            root, proofs = simple_proofs_from_hashes(list(leaf_hashes))
        ps = cls(total, root)
        for i, chunk in enumerate(chunks):
            part = Part(index=i, bytes_=chunk, proof=proofs[i], _hash=leaf_hashes[i])
            ps._parts[i] = part
            ps._bit_array.set_index(i, True)
        ps._count = total
        return ps

    @classmethod
    def from_header(cls, header: PartSetHeader) -> "PartSet":
        return cls(header.total, header.hash)

    # -- accessors ---------------------------------------------------------

    def header(self) -> PartSetHeader:
        return PartSetHeader(self._total, self._hash)

    def has_header(self, header: PartSetHeader) -> bool:
        return self.header() == header

    @property
    def total(self) -> int:
        return self._total

    def count(self) -> int:
        with self._mtx:
            return self._count

    def hash(self) -> bytes:
        return self._hash

    def bit_array(self) -> BitArray:
        with self._mtx:
            return self._bit_array.copy()

    def is_complete(self) -> bool:
        with self._mtx:
            return self._count == self._total

    def get_part(self, index: int) -> Part | None:
        with self._mtx:
            if 0 <= index < self._total:
                return self._parts[index]
            return None

    # -- filling -----------------------------------------------------------

    def add_part(self, part: Part) -> bool:
        """True if added, False if a duplicate; raises on a bad index or
        proof (types/part_set.go:188-214), the gossip receive path."""
        with self._mtx:
            if part.index >= self._total:
                raise UnexpectedIndexError(f"index {part.index} >= total {self._total}")
            if self._parts[part.index] is not None:
                return False
            if not part.proof.verify(part.index, self._total, part.hash(), self._hash):
                raise InvalidProofError(f"invalid proof for part {part.index}")
            self._parts[part.index] = part
            self._bit_array.set_index(part.index, True)
            self._count += 1
            return True

    def get_data(self) -> bytes:
        """Reassembled payload, only when complete (the reference's
        PartSetReader, types/part_set.go:233-276)."""
        with self._mtx:
            if self._count != self._total:
                raise PartSetError("part set incomplete")
            return b"".join(p.bytes_ for p in self._parts)  # type: ignore[union-attr]

    def __repr__(self):
        return f"PartSet{{{self.count()}/{self._total} {self._hash.hex()[:12]}}}"
