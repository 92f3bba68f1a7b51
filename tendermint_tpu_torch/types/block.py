"""Block = Header + Data(txs) + LastCommit + evidence (reference:
types/block.go).

Hashing layout kept from the reference:
- Header.hash = Merkle-of-map over the header fields (types/block.go:173-188)
- Commit.hash = Merkle root over encoded precommits (types/block.go:340-349)
- Data.hash   = Merkle root of tx hashes (types/tx.go:33-46)
- Block.hash  = Header.hash after fill_header

The block's wire bytes feed PartSet.from_data for gossip
(types/block.go:110-112). With the gateway's Hasher wired in
(`make_block`'s part hashers, `types.tx.set_batch_tx_root`) the part set
and the tx root hash on the card.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field

from tendermint_tpu_torch.codec import jsonval as jv
from tendermint_tpu_torch.codec.binary import Decoder, Encoder
from tendermint_tpu_torch.merkle.simple import leaf_hash, simple_hash_from_hashes, simple_hash_from_map
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.tx import Tx, txs_hash
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, Vote


@dataclass
class Header:
    chain_id: str = ""
    height: int = 0
    time_ns: int = 0
    num_txs: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    app_hash: bytes = b""
    evidence_hash: bytes = b""

    def hash(self) -> bytes:
        """Merkle-of-map; empty until validators_hash is set
        (types/block.go:173-188). The Evidence key joins the map only when
        the block carries evidence, so an evidence-free header hashes as
        the reference's."""
        if not self.validators_hash:
            return b""
        e = Encoder()
        self.last_block_id.encode(e)
        fields = {
            "ChainID": self.chain_id.encode(),
            "Height": Encoder().write_varint(self.height).buf(),
            "Time": Encoder().write_time_ns(self.time_ns).buf(),
            "NumTxs": Encoder().write_varint(self.num_txs).buf(),
            "LastBlockID": e.buf(),
            "LastCommit": self.last_commit_hash,
            "Data": self.data_hash,
            "Validators": self.validators_hash,
            "App": self.app_hash,
        }
        if self.evidence_hash:
            fields["Evidence"] = self.evidence_hash
        return simple_hash_from_map(fields)

    def encode(self, e: Encoder) -> None:
        e.write_string(self.chain_id)
        e.write_varint(self.height)
        e.write_time_ns(self.time_ns)
        e.write_varint(self.num_txs)
        self.last_block_id.encode(e)
        e.write_bytes(self.last_commit_hash)
        e.write_bytes(self.data_hash)
        e.write_bytes(self.validators_hash)
        e.write_bytes(self.app_hash)
        e.write_bytes(self.evidence_hash)

    @classmethod
    def decode(cls, d: Decoder) -> "Header":
        return cls(
            chain_id=d.read_string(),
            height=d.read_varint(),
            time_ns=d.read_time_ns(),
            num_txs=d.read_varint(),
            last_block_id=BlockID.decode(d),
            last_commit_hash=d.read_bytes(),
            data_hash=d.read_bytes(),
            validators_hash=d.read_bytes(),
            app_hash=d.read_bytes(),
            evidence_hash=d.read_bytes(),
        )

    def to_json(self):
        return {
            "chain_id": self.chain_id,
            "height": self.height,
            "time": self.time_ns,
            "num_txs": self.num_txs,
            "last_block_id": self.last_block_id.to_json(),
            "last_commit_hash": self.last_commit_hash.hex().upper(),
            "data_hash": self.data_hash.hex().upper(),
            "validators_hash": self.validators_hash.hex().upper(),
            "app_hash": self.app_hash.hex().upper(),
            "evidence_hash": self.evidence_hash.hex().upper(),
        }

    @classmethod
    def from_json(cls, obj) -> "Header":
        obj = jv.require_dict(obj)
        return cls(
            chain_id=jv.str_field(obj, "chain_id"),
            height=jv.int_field(obj, "height", 0, jv.MAX_HEIGHT),
            time_ns=jv.int_field(obj, "time", 0, jv.MAX_TIME_NS),
            num_txs=jv.int_field(obj, "num_txs", 0, jv.MAX_INDEX),
            last_block_id=BlockID.from_json(jv.dict_field(obj, "last_block_id")),
            last_commit_hash=jv.hex_field(obj, "last_commit_hash"),
            data_hash=jv.hex_field(obj, "data_hash"),
            validators_hash=jv.hex_field(obj, "validators_hash"),
            app_hash=jv.hex_field(obj, "app_hash"),
            # an absent field reads as empty (input hardening, not a
            # cross-version path: the binary codec is not either)
            evidence_hash=jv.hex_field(obj, "evidence_hash")
            if "evidence_hash" in obj else b"",
        )


class Commit:
    """Precommits index-aligned with that height's validator set. A
    precommit is None where its validator skipped."""

    def __init__(self, block_id: BlockID, precommits: list[Vote | None]):
        self.block_id = block_id
        self.precommits = precommits
        self._hash: bytes | None = None
        self._first: Vote | None = None

    def first_precommit(self) -> Vote | None:
        if self._first is None:
            self._first = next((p for p in self.precommits if p is not None), None)
        return self._first

    def height(self) -> int:
        fp = self.first_precommit()
        return fp.height if fp else 0

    def round_(self) -> int:
        fp = self.first_precommit()
        return fp.round_ if fp else 0

    def size(self) -> int:
        return len(self.precommits)

    def is_commit(self) -> bool:
        return len(self.precommits) != 0

    def validate_basic(self) -> str | None:
        """None if structurally valid; else an error string
        (types/block.go:305-338)."""
        if self.block_id.is_zero():
            return "commit cannot be for nil block"
        if not self.precommits:
            return "no precommits in commit"
        height, round_ = self.height(), self.round_()
        for p in self.precommits:
            if p is None:
                continue
            if p.type_ != VOTE_TYPE_PRECOMMIT:
                return f"invalid commit vote type {p.type_}"
            if p.height != height:
                return f"invalid commit precommit height {p.height} != {height}"
            if p.round_ != round_:
                return f"invalid commit precommit round {p.round_} != {round_}"
        return None

    def hash(self) -> bytes:
        """Merkle root over the encoded precommits; None entries hash as the
        empty encoding (types/block.go:340-349)."""
        if self._hash is None:
            leaves = [
                leaf_hash(p.to_bytes() if p is not None else b"")
                for p in self.precommits
            ]
            self._hash = simple_hash_from_hashes(leaves)
        return self._hash

    def encode(self, e: Encoder) -> None:
        self.block_id.encode(e)

        def write_precommit(enc: Encoder, p: Vote | None):
            if p is None:
                enc.write_u8(0)
            else:
                enc.write_u8(1)
                p.encode(enc)

        e.write_list(self.precommits, write_precommit)

    def to_bytes(self) -> bytes:
        e = Encoder()
        self.encode(e)
        return e.buf()

    @classmethod
    def decode(cls, d: Decoder) -> "Commit":
        bid = BlockID.decode(d)

        def read_precommit(dec: Decoder) -> Vote | None:
            if dec.read_u8() == 0:
                return None
            return Vote.decode(dec)

        return cls(bid, d.read_list(read_precommit))

    def to_json(self):
        return {
            "block_id": self.block_id.to_json(),
            "precommits": [p.to_json() if p else None for p in self.precommits],
        }

    @classmethod
    def from_json(cls, obj) -> "Commit":
        obj = jv.require_dict(obj)
        return cls(
            BlockID.from_json(jv.dict_field(obj, "block_id")),
            [
                # only JSON null means "validator skipped"; falsy garbage
                # (0, false, "", {}) must reject, not silently drop a vote
                Vote.from_json(p) if p is not None else None
                for p in jv.list_field(obj, "precommits", jv.MAX_INDEX)
            ],
        )

    def __repr__(self):
        n = sum(1 for p in self.precommits if p is not None)
        return f"Commit{{{n}/{len(self.precommits)} for {self.block_id!r}}}"


def empty_commit() -> Commit:
    """The height-1 LastCommit: empty but never nil (types/block.go:216)."""
    return Commit(BlockID(), [])


@dataclass
class Data:
    txs: list[Tx] = field(default_factory=list)
    _hash: bytes | None = None

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = txs_hash(self.txs)
        return self._hash

    def encode(self, e: Encoder) -> None:
        e.write_list(self.txs, lambda enc, tx: enc.write_bytes(tx))

    @classmethod
    def decode(cls, d: Decoder) -> "Data":
        return cls(d.read_list(lambda dec: dec.read_bytes()))

    def to_json(self):
        return {"txs": [tx.hex().upper() for tx in self.txs]}

    @classmethod
    def from_json(cls, obj) -> "Data":
        obj = jv.require_dict(obj)
        out = []
        for t in jv.list_field(obj, "txs", jv.MAX_INDEX):
            if not isinstance(t, str) or len(t) > 2 * jv.MAX_TX_BYTES:
                raise ValueError("bad tx in block data")
            try:
                out.append(bytes.fromhex(t))
            except ValueError as exc:
                raise ValueError("bad tx in block data: not hex") from exc
        return cls(out)


class Block:
    def __init__(self, header: Header, data: Data, last_commit, evidence=None):
        from tendermint_tpu_torch.types.evidence import EvidenceData

        self.header = header
        self.data = data
        self.last_commit = last_commit
        self.evidence = evidence if evidence is not None else EvidenceData()

    @classmethod
    def make_block(
        cls,
        height: int,
        chain_id: str,
        txs: list[Tx],
        commit,
        prev_block_id: BlockID,
        val_hash: bytes,
        app_hash: bytes,
        part_size: int,
        time_ns: int | None = None,
        part_hasher=None,
        part_tree_hasher=None,
        part_tree_submitter=None,
        evidence=None,
    ) -> tuple["Block", PartSet]:
        """MakeBlock (types/block.go:26-44): the block and its part set.
        `evidence` is the proposer's drained pool (an EvidenceData or a
        plain list); omitted, an empty section whose header hashes as the
        reference's."""
        from tendermint_tpu_torch.types.evidence import EvidenceData

        if evidence is None:
            evidence = EvidenceData()
        elif not isinstance(evidence, EvidenceData):
            evidence = EvidenceData(list(evidence))
        header = Header(
            chain_id=chain_id,
            height=height,
            time_ns=time_ns if time_ns is not None else _time.time_ns(),
            num_txs=len(txs),
            last_block_id=prev_block_id,
            validators_hash=val_hash,
            app_hash=app_hash,
        )
        block = cls(header, Data(txs=list(txs)), commit, evidence=evidence)
        block.fill_header()
        return block, block.make_part_set(
            part_size, hasher=part_hasher, tree_hasher=part_tree_hasher,
            tree_submitter=part_tree_submitter,
        )

    def fill_header(self) -> None:
        if not self.header.last_commit_hash:
            self.header.last_commit_hash = self.last_commit.hash()
        if not self.header.data_hash:
            self.header.data_hash = self.data.hash()
        if not self.header.evidence_hash:
            self.header.evidence_hash = self.evidence.hash()

    def hash(self) -> bytes:
        if self.header is None or self.data is None or self.last_commit is None:
            return b""
        self.fill_header()
        return self.header.hash()

    def hashes_to(self, h: bytes) -> bool:
        return len(h) > 0 and self.hash() == h

    def make_part_set(self, part_size: int, hasher=None,
                      tree_hasher=None, tree_submitter=None) -> PartSet:
        return PartSet.from_data(
            self.to_bytes(), part_size, hasher=hasher,
            tree_hasher=tree_hasher, tree_submitter=tree_submitter,
        )

    def commit_format(self) -> str:
        """The wire format this block's last_commit carries."""
        from tendermint_tpu_torch.types.agg_commit import AggregateCommit

        return "aggregate" if isinstance(self.last_commit, AggregateCommit) else "full"

    def validate_basic(
        self,
        chain_id: str,
        last_block_height: int,
        last_block_id: BlockID,
        app_hash: bytes,
        commit_format: str | None = None,
    ) -> str | None:
        """Stateless validation (types/block.go:48-85); None when OK.
        `commit_format`, when given, is the format the chain's upgrade
        schedule requires at this height: a block carrying its last_commit
        in the other form is refused by name, not by a later hash
        mismatch."""
        h = self.header
        if h.chain_id != chain_id:
            return f"wrong chain_id: {h.chain_id} != {chain_id}"
        if h.height != last_block_height + 1:
            return f"wrong height: {h.height} != {last_block_height + 1}"
        if h.num_txs != len(self.data.txs):
            return f"wrong num_txs: {h.num_txs} != {len(self.data.txs)}"
        if h.last_block_id != last_block_id:
            return f"wrong last_block_id: {h.last_block_id} != {last_block_id}"
        if commit_format is not None and h.height != 1:
            got = self.commit_format()
            if got != commit_format:
                return (
                    f"wrong last_commit format at height {h.height}: "
                    f"got {got}, schedule requires {commit_format}"
                )
        if h.last_commit_hash != self.last_commit.hash():
            return "wrong last_commit_hash"
        if h.height != 1:
            err = self.last_commit.validate_basic()
            if err:
                return err
        if h.data_hash != self.data.hash():
            return "wrong data_hash"
        if h.evidence_hash != self.evidence.hash():
            return "wrong evidence_hash"
        if h.app_hash != app_hash:
            return f"wrong app_hash: {h.app_hash.hex()} != {app_hash.hex()}"
        return None

    # -- binary ------------------------------------------------------------

    def encode(self, e: Encoder) -> None:
        self.header.encode(e)
        self.data.encode(e)
        self.last_commit.encode(e)
        self.evidence.encode(e)

    def to_bytes(self) -> bytes:
        e = Encoder()
        self.encode(e)
        return e.buf()

    @classmethod
    def decode(cls, d: Decoder) -> "Block":
        from tendermint_tpu_torch.types.agg_commit import AGG_COMMIT_TAG, AggregateCommit
        from tendermint_tpu_torch.types.evidence import EvidenceData

        header = Header.decode(d)
        data = Data.decode(d)
        # a self-describing last commit: the aggregate form leads with a
        # magic byte no full Commit starts with; whether the format is
        # allowed at this height is validate_basic's check
        if d.peek_u8() == AGG_COMMIT_TAG:
            last_commit = AggregateCommit.decode(d)
        else:
            last_commit = Commit.decode(d)
        return cls(header, data, last_commit, evidence=EvidenceData.decode(d))

    @classmethod
    def from_bytes(cls, b: bytes) -> "Block":
        d = Decoder(b)
        block = cls.decode(d)
        if not d.done():
            raise ValueError("trailing bytes after block")
        return block

    def to_json(self):
        return {
            "header": self.header.to_json(),
            "data": self.data.to_json(),
            "last_commit": self.last_commit.to_json(),
            "evidence": self.evidence.to_json(),
        }

    @classmethod
    def from_json(cls, obj) -> "Block":
        from tendermint_tpu_torch.types.agg_commit import commit_from_json
        from tendermint_tpu_torch.types.evidence import EvidenceData

        obj = jv.require_dict(obj)
        return cls(
            Header.from_json(jv.dict_field(obj, "header")),
            Data.from_json(jv.dict_field(obj, "data")),
            commit_from_json(jv.dict_field(obj, "last_commit")),
            evidence=(
                EvidenceData.from_json(jv.dict_field(obj, "evidence"))
                if "evidence" in obj else EvidenceData()
            ),
        )

    def block_id(self, part_set: PartSet) -> BlockID:
        return BlockID(self.hash(), part_set.header())

    def __repr__(self):
        return f"Block#{self.hash().hex()[:12]}{{h:{self.header.height} txs:{len(self.data.txs)}}}"
