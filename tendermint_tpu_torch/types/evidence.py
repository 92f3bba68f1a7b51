"""Duplicate-vote evidence: proof a validator signed two conflicting
votes at the same (height, round, type).

Beyond the reference: Tendermint v0.11 detects conflicting votes and stops
at a TODO (consensus/state.go:1438-1447; VoteSet surfaces them as
ErrVoteConflictingVotes, types/vote_set.go:137-172). Here the detection
site hands the pair to an EvidencePool, and blocks carry an EvidenceData
section whose Merkle root rides the header as `evidence_hash`: the
proposer drains the pool's pending set into each proposal, every
validator re-validates the section before prevoting, and finalize marks
the pieces committed, so one node's detection puts the proof on chain.
Punishment remains application policy, as in the reference.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from tendermint_tpu_torch.codec.binary import Decoder, Encoder
from tendermint_tpu_torch.crypto.hashing import ripemd160
from tendermint_tpu_torch.crypto.keys import pub_key_from_json
from tendermint_tpu_torch.types.vote import Vote

# bound per block: evidence is ~600 B a piece (two signed votes + key);
# 64 keeps the worst-case section far below one 64 KB block part
MAX_EVIDENCE_PER_BLOCK = 64


class EvidenceError(Exception):
    pass


@dataclass(frozen=True)
class DuplicateVoteEvidence:
    """Two votes by one validator for the same (H, R, type) but
    different blocks. vote_a/vote_b are stored in canonical order
    (sorted by block-id key) so the same conflict always hashes the
    same regardless of arrival order."""

    pub_key: object  # PubKeyEd25519 | PubKeySecp256k1 (crypto/keys.py)
    vote_a: Vote
    vote_b: Vote

    @staticmethod
    def new(pub_key, vote_a: Vote, vote_b: Vote) -> "DuplicateVoteEvidence":
        if vote_b.block_id.key() < vote_a.block_id.key():
            vote_a, vote_b = vote_b, vote_a
        return DuplicateVoteEvidence(pub_key, vote_a, vote_b)

    @property
    def height(self) -> int:
        return self.vote_a.height

    @property
    def address(self) -> bytes:
        return self.vote_a.validator_address

    def validate(self, chain_id: str, batch_verifier=None) -> None:
        """Raise EvidenceError unless this really is a double-sign: same
        validator/H/R/type, DIFFERENT blocks, both signatures valid
        under pub_key for this chain. Anyone can forge an unvalidated
        pair; a validated one is cryptographic proof.

        batch_verifier: callable(items) -> list[bool] — the
        gateway batch plane (ops.gateway.Verifier.commit_batch_verifier);
        None keeps the per-signature pure path."""
        self.validate_structure(chain_id)
        if batch_verifier is not None:
            oks = batch_verifier(self.sig_items(chain_id))
            if not all(oks):
                raise EvidenceError("invalid signature on evidence vote")
            return
        for v in (self.vote_a, self.vote_b):
            if not self.pub_key.verify_bytes(v.sign_bytes(chain_id), v.signature):
                raise EvidenceError("invalid signature on evidence vote")

    def validate_structure(self, chain_id: str) -> None:
        """Everything validate checks BEFORE signatures (the split:
        EvidenceData.validate batches every piece's signatures through
        one gateway call after the structural pass)."""
        a, b = self.vote_a, self.vote_b
        if (
            a.validator_address != b.validator_address
            or a.height != b.height
            or a.round_ != b.round_
            or a.type_ != b.type_
        ):
            raise EvidenceError("votes are not for the same (val, H, R, type)")
        if a.block_id.key() == b.block_id.key():
            raise EvidenceError("votes agree — no conflict")
        if b.block_id.key() < a.block_id.key():
            # canonical order is part of validity: otherwise the same
            # conflict hashes two ways and dedup double-counts it
            raise EvidenceError("evidence votes not in canonical order")
        if self.pub_key.address() != a.validator_address:
            raise EvidenceError("pub_key does not match validator address")
        for v in (a, b):
            if v.signature is None:
                raise EvidenceError("invalid signature on evidence vote")

    def sig_items(self, chain_id: str) -> list:
        """The two gateway verify lanes (pubkey, sign_bytes, signature);
        call after validate_structure (signatures proven present)."""
        return [
            (self.pub_key.raw, v.sign_bytes(chain_id), v.signature.raw)
            for v in (self.vote_a, self.vote_b)
        ]

    def hash(self) -> bytes:
        return ripemd160(
            self.vote_a.sign_bytes("") + b"/" + self.vote_b.sign_bytes("")
        )

    # -- binary (block embedding) ------------------------------------------

    def encode(self, e: Encoder) -> None:
        e.write_bytes(self.pub_key.bytes_())
        self.vote_a.encode(e)
        self.vote_b.encode(e)

    def to_bytes(self) -> bytes:
        e = Encoder()
        self.encode(e)
        return e.buf()

    @classmethod
    def decode(cls, d: Decoder) -> "DuplicateVoteEvidence":
        from tendermint_tpu_torch.crypto.keys import pub_key_from_bytes

        pub = pub_key_from_bytes(d.read_bytes())
        return cls(pub, Vote.decode(d), Vote.decode(d))

    def to_json(self):
        return {
            "type": "duplicate_vote",
            "height": self.height,
            "round": self.vote_a.round_,
            "vote_type": self.vote_a.type_,
            "validator_address": self.address.hex().upper(),
            "pub_key": self.pub_key.to_json(),
            "vote_a": self.vote_a.to_json(),
            "vote_b": self.vote_b.to_json(),
        }

    @classmethod
    def from_json(cls, obj) -> "DuplicateVoteEvidence":
        from tendermint_tpu_torch.codec import jsonval as jv

        obj = jv.require_dict(obj)
        if obj.get("type") != "duplicate_vote":
            raise ValueError(f"unknown evidence type {obj.get('type')!r}")
        return cls(
            pub_key_from_json(obj.get("pub_key")),
            Vote.from_json(jv.dict_field(obj, "vote_a")),
            Vote.from_json(jv.dict_field(obj, "vote_b")),
        )


class EvidencePool:
    """Bounded, deduplicated store of validated evidence. Thread-safe:
    the consensus receive routine adds, the RPC thread lists."""

    def __init__(self, max_size: int = 1024):
        self._max = max_size
        self._by_hash: dict[bytes, DuplicateVoteEvidence] = {}
        self._order: list[bytes] = []
        # committed-hash memory is FIFO-bounded like the pool itself (a
        # dict for insertion order): pruning the oldest is safe — its
        # piece is deep in chain history, and a replayed copy would be
        # rejected by block validation long before it mattered
        self._committed: dict[bytes, None] = {}
        self._committed_max = max(4 * max_size, 4096)
        self._mtx = threading.Lock()

    def add(self, ev: DuplicateVoteEvidence, chain_id: str,
            batch_verifier=None) -> bool:
        """Validate + insert; False if duplicate or invalid (invalid
        evidence is dropped, not raised — the vote path must not die on
        a malformed pair). Dedup runs BEFORE validation: a peer
        re-gossiping a known conflict must cost a hash, not two ed25519
        verifies per replay. `batch_verifier` routes the pair's two
        signatures through one gateway batch."""
        h = ev.hash()
        with self._mtx:
            if h in self._by_hash:
                return False
        try:
            ev.validate(chain_id, batch_verifier=batch_verifier)
        except EvidenceError:
            return False
        with self._mtx:
            if h in self._by_hash:
                return False
            if len(self._order) >= self._max:
                old = self._order.pop(0)
                self._by_hash.pop(old, None)
            self._by_hash[h] = ev
            self._order.append(h)
            return True

    def list(self) -> list[DuplicateVoteEvidence]:
        with self._mtx:
            return [self._by_hash[h] for h in self._order]

    def size(self) -> int:
        with self._mtx:
            return len(self._order)

    # -- block embedding ---------------------------------------------------

    def pending(self, limit: int = MAX_EVIDENCE_PER_BLOCK,
                before_height: int | None = None) -> list:
        """Validated evidence not yet seen in a committed block — what a
        proposer drains into its next proposal. `before_height` is the
        PROPOSAL height: a block may only carry strictly-older evidence
        (EvidenceData.validate), so same-height detections wait one
        height."""
        with self._mtx:
            out = []
            for h in self._order:
                if h in self._committed:
                    continue
                ev = self._by_hash[h]
                if before_height is not None and ev.height >= before_height:
                    continue
                out.append(ev)
                if len(out) >= limit:
                    break
            return out

    def min_pending_height(self) -> int | None:
        """Lowest height referenced by evidence still awaiting commit —
        the retention coordinator's evidence floor: blocks at
        and above a pending piece's height stay on disk so operators and
        peers can audit the conflict it proves. None when nothing is
        pending."""
        with self._mtx:
            heights = [
                self._by_hash[h].height
                for h in self._order
                if h not in self._committed
            ]
            return min(heights) if heights else None

    def mark_committed(self, evidence: list) -> None:
        """A block carrying `evidence` was committed: remember each piece
        so it is never re-proposed, and adopt pieces this node had not
        detected itself (they arrived cryptographically validated — the
        block passed validate_block before apply), so every node's
        `evidence` RPC converges on the on-chain set."""
        with self._mtx:
            for ev in evidence:
                h = ev.hash()
                self._committed[h] = None
                while len(self._committed) > self._committed_max:
                    self._committed.pop(next(iter(self._committed)))
                if h not in self._by_hash:
                    if len(self._order) >= self._max:
                        # evict an already-committed entry first: a
                        # pending (detected, not-yet-proposed) piece must
                        # never be forgotten to remember one that is
                        # already on chain
                        victim_i = next(
                            (i for i, old in enumerate(self._order)
                             if old in self._committed),
                            0,
                        )
                        old = self._order.pop(victim_i)
                        self._by_hash.pop(old, None)
                    self._by_hash[h] = ev
                    self._order.append(h)

    def committed_count(self) -> int:
        with self._mtx:
            return len(self._committed)


@dataclass
class EvidenceData:
    """The block's evidence section (mirrors Data for txs): a bounded
    list of DuplicateVoteEvidence, Merkle-rooted into the header as
    `evidence_hash` (empty list = empty hash = a header byte-identical
    to the pre-evidence format)."""

    evidence: list = field(default_factory=list)
    _hash: bytes | None = None

    def hash(self) -> bytes:
        from tendermint_tpu_torch.merkle.simple import leaf_hash, simple_hash_from_hashes

        if self._hash is None:
            if not self.evidence:
                self._hash = b""
            else:
                self._hash = simple_hash_from_hashes(
                    [leaf_hash(ev.to_bytes()) for ev in self.evidence]
                )
        return self._hash

    def validate(self, chain_id: str, block_height: int, validators,
                 batch_verifier=None) -> None:
        """Raise EvidenceError unless every piece is a provable,
        in-committee, prior-height double-sign and the section carries no
        duplicates (the proposer controls this list — it is adversarial
        input to every other validator).

        batch_verifier: with the gateway batch plane wired,
        every structural check runs first and then ALL pieces' signatures
        (two per piece) flush in ONE batched call — per-lane verdicts
        keep attribution, so a forged lane names exactly its piece."""
        if len(self.evidence) > MAX_EVIDENCE_PER_BLOCK:
            raise EvidenceError(
                f"too much evidence: {len(self.evidence)} > {MAX_EVIDENCE_PER_BLOCK}"
            )
        seen: set[bytes] = set()
        for ev in self.evidence:
            if not isinstance(ev, DuplicateVoteEvidence):
                raise EvidenceError("unknown evidence kind in block")
            h = ev.hash()
            if h in seen:
                raise EvidenceError("duplicate evidence in block")
            seen.add(h)
            if not 1 <= ev.height < block_height:
                raise EvidenceError(
                    f"evidence height {ev.height} outside [1, {block_height})"
                )
            if validators is not None and not validators.has_address(ev.address):
                raise EvidenceError(
                    f"evidence validator {ev.address.hex()[:12]} not in the set"
                )
            if batch_verifier is None:
                ev.validate(chain_id)
            else:
                ev.validate_structure(chain_id)
        if batch_verifier is not None and self.evidence:
            items = []
            for ev in self.evidence:
                items.extend(ev.sig_items(chain_id))
            oks = batch_verifier(items)
            for i, ev in enumerate(self.evidence):
                if not all(oks[2 * i : 2 * i + 2]):
                    raise EvidenceError(
                        "invalid signature on evidence vote (piece "
                        f"{i}, validator {ev.address.hex()[:12]})"
                    )

    def encode(self, e: Encoder) -> None:
        e.write_list(self.evidence, lambda enc, ev: ev.encode(enc))

    @classmethod
    def decode(cls, d: Decoder) -> "EvidenceData":
        return cls(d.read_list(DuplicateVoteEvidence.decode))

    def to_json(self):
        return {"evidence": [ev.to_json() for ev in self.evidence]}

    @classmethod
    def from_json(cls, obj) -> "EvidenceData":
        from tendermint_tpu_torch.codec import jsonval as jv

        obj = jv.require_dict(obj)
        return cls(
            [
                DuplicateVoteEvidence.from_json(o)
                for o in jv.list_field(obj, "evidence", MAX_EVIDENCE_PER_BLOCK)
            ]
        )
