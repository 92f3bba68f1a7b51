"""AggregateCommit: +2/3 precommits as one object instead of N signed
votes (the JAX package's types/agg_commit.py; docs/committee.md,
docs/upgrade.md).

The precommits that form the quorum all sign the same canonical payload
(vote sign bytes exclude the validator identity), so the commit section
compresses to the block id, (height, round), a signer bit array over the
validator set, one 32-byte nonce point R per signer and one folded scalar:
Ed25519 half-aggregation (crypto/ed25519_agg.py). Once a chain passes its
upgrade height every commit takes this form.

The wire form leads with a magic tag byte (0xAC) no full Commit can start
with, and `decode_commit` accepts it only where the chain's schedule allows
aggregate commits: a full-format node refuses an aggregate loudly.

`verify` checks the signer set and the quorum on the host, then hands the
one multi-term equation to the gateway (ops/gateway.Verifier
.verify_aggregate), whose n + 1 dual scalar multiplications run in the
CUDA dsm kernel. `AggregateLastCommit` is consensus's stand-in for a
LastCommit known only as a verified aggregate.
"""

from __future__ import annotations

from tendermint_tpu_torch.codec import jsonval as jv
from tendermint_tpu_torch.codec.binary import Decoder, Encoder
from tendermint_tpu_torch.crypto import ed25519_agg
from tendermint_tpu_torch.libs.bitarray import BitArray
from tendermint_tpu_torch.merkle.simple import leaf_hash
from tendermint_tpu_torch.types.block import Commit
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.validator_set import CommitError, ValidatorSet
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, Vote

# leading wire byte; a full Commit starts with its block-id hash's varint
# length byte (0x00 empty / 0x14 twenty) — never this
AGG_COMMIT_TAG = 0xAC

MAX_AGG_SIGNERS = 1 << 16


class AggregateCommit:
    """(block_id, height, round, signer bits, R per signer, s_agg)."""

    def __init__(self, block_id: BlockID, height: int, round_: int,
                 signers: BitArray, rs: list[bytes], s_agg: bytes):
        self.block_id = block_id
        self._height = height
        self._round = round_
        self.signers = signers
        self.rs = rs
        self.s_agg = s_agg
        self._hash: bytes | None = None

    # -- Commit-mirroring accessors (keep consumers polymorphic) -----------

    def height(self) -> int:
        return self._height

    def round_(self) -> int:
        return self._round

    def type_(self) -> int:
        return VOTE_TYPE_PRECOMMIT

    def size(self) -> int:
        """Validator-set size the signer bits span (Commit.size parity:
        the set size, not the signer count)."""
        return self.signers.size

    def num_signers(self) -> int:
        return len(self.rs)

    def bit_array(self) -> BitArray:
        return self.signers.copy()

    def is_commit(self) -> bool:
        return len(self.rs) != 0

    def validate_basic(self) -> str | None:
        """None if structurally valid; else an error string (the
        aggregate counterpart of Commit.validate_basic)."""
        if self.block_id.is_zero():
            return "aggregate commit cannot be for nil block"
        if not self.rs:
            return "no signers in aggregate commit"
        if not 0 < self.signers.size <= MAX_AGG_SIGNERS:
            return f"bad signer-set size {self.signers.size}"
        if len(self.rs) != self.signers.num_true_bits():
            return "signer bits do not match nonce points"
        if any(len(r) != 32 for r in self.rs):
            return "nonce point not 32 bytes"
        if len(self.s_agg) != 32:
            return "aggregate scalar not 32 bytes"
        return None

    def hash(self) -> bytes:
        """What the NEXT header's last_commit_hash commits to when the
        aggregate format is active: the leaf hash of the canonical wire
        form (one leaf — the object IS the whole commit section)."""
        if self._hash is None:
            self._hash = leaf_hash(self.to_bytes())
        return self._hash

    # -- construction ------------------------------------------------------

    @classmethod
    def from_commit(cls, commit: Commit, chain_id: str,
                    val_set: ValidatorSet) -> "AggregateCommit":
        """Aggregate a full Commit's quorum precommits. Only ed25519
        precommits FOR the commit's block join (off-block precommits and
        other key types cannot — see module docstring); raises
        CommitError if what remains cannot carry +2/3 of `val_set`."""
        height, round_ = commit.height(), commit.round_()
        items, idxs, power = [], [], 0
        for idx, pre in enumerate(commit.precommits):
            if pre is None or pre.signature is None:
                continue
            if (
                pre.block_id != commit.block_id
                or pre.height != height
                or pre.round_ != round_
                or len(pre.signature.raw) != 64
            ):
                continue
            _, val = val_set.get_by_index(idx)
            if val is None or len(val.pub_key.raw) != 32:
                continue
            items.append(
                (val.pub_key.raw, pre.sign_bytes(chain_id), pre.signature.raw)
            )
            idxs.append(idx)
            power += val.voting_power
        if power * 3 <= val_set.total_voting_power() * 2:
            raise CommitError(
                f"aggregable precommits carry only {power}/"
                f"{val_set.total_voting_power()} power"
            )
        rs, s_agg = ed25519_agg.aggregate(items)
        return cls(
            commit.block_id, height, round_,
            BitArray.from_indices(val_set.size(), idxs), rs, s_agg,
        )

    # -- verification ------------------------------------------------------

    def sign_message(self, chain_id: str) -> bytes:
        """The ONE canonical payload every aggregated lane signed (vote
        sign-bytes exclude the validator identity)."""
        return Vote(
            validator_address=b"", validator_index=0, height=self._height,
            round_=self._round, type_=VOTE_TYPE_PRECOMMIT,
            block_id=self.block_id,
        ).sign_bytes(chain_id)

    def verify(self, chain_id: str, val_set: ValidatorSet,
               agg_verifier=None) -> None:
        """Raise CommitError unless the aggregate carries +2/3 of
        `val_set` AND the half-aggregate equation holds for every signer
        lane — the whole commit's crypto in one multi-term check.

        `agg_verifier` is a callable (pubs, msgs, rs, s_agg) -> bool; by
        default the gateway's batched dual-scalar-mul path on the card
        (ops/gateway.Verifier.verify_aggregate, with the pure-Python
        reference as its floor below the size gate)."""
        idxs = self.signers.indices()
        if self.signers.size != val_set.size():
            raise CommitError(
                f"wrong set size: {self.signers.size} vs {val_set.size()}"
            )
        if len(idxs) != len(self.rs):
            raise CommitError(
                f"signer bits ({len(idxs)}) != nonce points ({len(self.rs)})"
            )
        pubs, power = [], 0
        for idx in idxs:
            _, val = val_set.get_by_index(idx)
            if val is None:
                raise CommitError(f"signer index {idx} not in the set")
            if len(val.pub_key.raw) != 32:
                raise CommitError(f"signer {idx} is not an ed25519 key")
            pubs.append(val.pub_key.raw)
            power += val.voting_power
        if power * 3 <= val_set.total_voting_power() * 2:
            raise CommitError(
                f"insufficient voting power: got {power}, "
                f"needed {val_set.total_voting_power() * 2 // 3 + 1}"
            )
        msg = self.sign_message(chain_id)
        if agg_verifier is None:
            agg_verifier = _default_agg_verifier()
        if not agg_verifier(pubs, [msg] * len(pubs), self.rs, self.s_agg):
            raise CommitError("aggregate signature failed verification")

    # -- wire --------------------------------------------------------------

    def encode(self, e: Encoder) -> None:
        e.write_u8(AGG_COMMIT_TAG)
        self.block_id.encode(e)
        e.write_varint(self._height)
        e.write_varint(self._round)
        e.write_varint(self.signers.size)
        e.write_list(self.signers.indices(), lambda enc, i: enc.write_varint(i))
        e.write_raw(b"".join(self.rs))
        e.write_raw(self.s_agg)

    def to_bytes(self) -> bytes:
        e = Encoder()
        self.encode(e)
        return e.buf()

    @classmethod
    def decode(cls, d: Decoder) -> "AggregateCommit":
        if d.read_u8() != AGG_COMMIT_TAG:
            raise ValueError("not an aggregate commit")
        block_id = BlockID.decode(d)
        height = d.read_varint()
        round_ = d.read_varint()
        size = d.read_varint()
        if not 0 < size <= MAX_AGG_SIGNERS:
            raise ValueError(f"bad signer-set size {size}")
        idxs = d.read_list(lambda dec: dec.read_varint())
        if len(idxs) > size or any(not 0 <= i < size for i in idxs):
            raise ValueError("signer index out of range")
        # strictly ascending is the canonical (and only) wire order:
        # verify() pairs rs with signers.indices() (sorted), so any
        # other order would mispair lanes and reject a valid aggregate
        if any(a >= b for a, b in zip(idxs, idxs[1:])):
            raise ValueError("signer indices not strictly ascending")
        rs = [d.read_raw(32) for _ in range(len(idxs))]
        s_agg = d.read_raw(32)
        return cls(block_id, height, round_,
                   BitArray.from_indices(size, idxs), rs, s_agg)

    @classmethod
    def from_bytes(cls, b: bytes) -> "AggregateCommit":
        d = Decoder(b)
        out = cls.decode(d)
        if not d.done():
            raise ValueError("trailing bytes after aggregate commit")
        return out

    # -- json --------------------------------------------------------------

    def to_json(self):
        return {
            "block_id": self.block_id.to_json(),
            "height": self._height,
            "round": self._round,
            "signers": self.signers.to_json(),
            "rs": [r.hex().upper() for r in self.rs],
            "s_agg": self.s_agg.hex().upper(),
        }

    @classmethod
    def from_json(cls, obj) -> "AggregateCommit":
        obj = jv.require_dict(obj)
        signers_obj = jv.require_dict(obj.get("signers"))
        bits = jv.int_field(signers_obj, "bits", 1, MAX_AGG_SIGNERS)
        elems = signers_obj.get("elems")
        if not isinstance(elems, str) or len(elems) > (bits // 4) + 2:
            raise ValueError("bad signer bit array")
        try:
            signers = BitArray.from_int(bits, int(elems or "0", 16))
        except ValueError as exc:
            raise ValueError("bad signer bit array") from exc
        rs_hex = jv.list_field(obj, "rs", MAX_AGG_SIGNERS)
        rs = []
        for r in rs_hex:
            if not isinstance(r, str) or len(r) != 64:
                raise ValueError("bad nonce point hex")
            rs.append(bytes.fromhex(r))
        if len(rs) != signers.num_true_bits():
            raise ValueError("signer bits do not match nonce points")
        return cls(
            BlockID.from_json(jv.dict_field(obj, "block_id")),
            jv.int_field(obj, "height", 0, jv.MAX_HEIGHT),
            jv.int_field(obj, "round", 0, jv.MAX_ROUND),
            signers,
            rs,
            jv.hex_field(obj, "s_agg"),
        )

    def __repr__(self):
        return (
            f"AggregateCommit{{{len(self.rs)}/{self.signers.size} "
            f"for {self.block_id!r}}}"
        )


class AggregateLastCommit:
    """rs.last_commit stand-in when only a VERIFIED AggregateCommit is
    available for the previous height — commit-proof catchup and restart
    from an aggregate seen-commit (consensus/state.py). It carries no
    individual votes: vote-gossip picks nothing from it (bit_array() is
    empty; the reactor's aggregate catchup branch ships the whole commit
    instead), late precommits cannot be absorbed (begin_add refuses as a
    duplicate), but proposing at the next height works — make_commit()
    IS the aggregate, exactly what the schedule requires the next
    block's last_commit section to be."""

    def __init__(self, agg: "AggregateCommit", val_set: ValidatorSet):
        self.agg = agg
        self.val_set = val_set  # the set that signed (VoteSet parity)
        self.height = agg.height()
        self.round_ = agg.round_()
        self.type_ = VOTE_TYPE_PRECOMMIT

    def size(self) -> int:
        return self.agg.size()

    def has_two_thirds_majority(self) -> bool:
        return True  # verified against val_set before construction

    def two_thirds_majority(self):
        return self.agg.block_id

    def has_all(self) -> bool:
        return self.agg.num_signers() == self.agg.size()

    def make_commit(self):
        return self.agg

    def bit_array(self) -> BitArray:
        # EMPTY by design: pick_vote_to_send must never find a per-vote
        # lane here (there are none to send)
        return BitArray(self.agg.size())

    def get_by_index(self, index: int):
        # truthy for "this lane is covered" screens (vote_batcher), but
        # unreachable from vote gossip (bit_array above is empty)
        return self.agg if self.agg.signers.get_index(index) else None

    def begin_add(self, vote):
        return None  # cannot absorb votes; reads as an exact duplicate

    def add_vote(self, vote, verifier=None) -> bool:
        return False

    def __repr__(self):
        return f"AggregateLastCommit{{{self.agg!r}}}"


def _default_agg_verifier():
    """The gateway-batched aggregate verifier on the card, resolved lazily
    (types/ must not import ops/ at module load). Unlike the JAX package
    there is no fallback to the pure-Python reference: a gateway that
    cannot start, or a kernel that fails, raises."""
    from tendermint_tpu_torch.ops.gateway import default_verifier

    return default_verifier().verify_aggregate


def decode_commit(d: Decoder, aggregate_commits: bool = False):
    """Format-flag-aware commit decode: dispatches on the aggregate
    magic tag. `aggregate_commits` is whether the chain's schedule
    allows the aggregate format AT THIS HEIGHT (genesis
    ``commit_format_at``) — a node fed an aggregate commit for a
    full-format height refuses HERE, loudly (the mixed-net refusal
    test, tests/test_vote_batch.py)."""
    if d.peek_u8() == AGG_COMMIT_TAG:
        if not aggregate_commits:
            raise ValueError(
                "aggregate commit refused: this chain runs "
                "commit_format=full at this height (mixed-net refusal, "
                "docs/committee.md; upgrade schedule, docs/upgrade.md)"
            )
        return AggregateCommit.decode(d)
    return Commit.decode(d)


def commit_from_json(obj):
    """Polymorphic commit parse: aggregate JSON carries ``s_agg``, full
    carries ``precommits`` — the RPC /commit, statesync manifests, and
    the light client all accept either form and verify by the schedule."""
    if isinstance(obj, dict) and "s_agg" in obj:
        return AggregateCommit.from_json(obj)
    return Commit.from_json(obj)


def commit_is_aggregate(commit) -> bool:
    return isinstance(commit, AggregateCommit)
