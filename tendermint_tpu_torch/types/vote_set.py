"""VoteSet: collects signatures from validators at one (height, round,
type) while tracking double-sign conflicts with bounded memory
(reference: types/vote_set.go, with its two stores, votes and
votesByBlock, and its memory-bounding argument).

`add_vote` takes an optional single-item verifier (the gateway's
`vote_verifier()`); the accept/reject behaviour is the same either way.
The add also comes in two halves, so a caller can batch the signatures
of a run of votes: `begin_add` runs every check but the signature's and
returns a `PendingVote` whose `item()` is the gateway's verify tuple;
`commit_add(pending, ok)` applies the verdict with add_vote's errors (a
bad signature rejects only its own vote). `add_vote` is the two halves
in sequence, so the paths cannot drift apart.
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.libs.bitarray import BitArray
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.block import Commit
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import (
    ConflictingVotesError,
    InvalidSignatureError,
    InvalidValidatorAddressError,
    InvalidValidatorIndexError,
    UnexpectedStepError,
    VOTE_TYPE_PRECOMMIT,
    Vote,
)


class _BlockVotes:
    """Votes for one particular block key (types/vote_set.go:483-520)."""

    def __init__(self, peer_maj23: bool, num_validators: int):
        self.peer_maj23 = peer_maj23
        self.bit_array = BitArray(num_validators)
        self.votes: list[Vote | None] = [None] * num_validators
        self.sum = 0

    def add_verified_vote(self, vote: Vote, voting_power: int) -> None:
        i = vote.validator_index
        if self.votes[i] is None:
            self.bit_array.set_index(i, True)
            self.votes[i] = vote
            self.sum += voting_power

    def get_by_index(self, index: int) -> Vote | None:
        return self.votes[index]


class PendingVote:
    """The structural half of an add: produced by
    `VoteSet.begin_add` once every non-signature check passed. `item()`
    is the gateway verify tuple; `commit(ok)` applies the signature
    verdict and finishes the insertion with add_vote's error taxonomy."""

    __slots__ = ("vote_set", "vote", "val", "sign_bytes", "block_key")

    def __init__(self, vote_set: "VoteSet", vote: Vote, val, sign_bytes: bytes,
                 block_key: bytes):
        self.vote_set = vote_set
        self.vote = vote
        self.val = val
        self.sign_bytes = sign_bytes
        self.block_key = block_key

    def item(self) -> tuple[bytes, bytes, bytes]:
        """(pubkey, message, signature) — the ops.gateway batch lane."""
        return (self.val.pub_key.raw, self.sign_bytes, self.vote.signature.raw)

    def commit(self, ok: bool) -> bool:
        return self.vote_set.commit_add(self, ok)


class VoteSet:
    def __init__(
        self, chain_id: str, height: int, round_: int, type_: int, val_set: ValidatorSet
    ):
        if height == 0:
            raise ValueError("cannot make VoteSet for height 0")
        self.chain_id = chain_id
        self.height = height
        self.round_ = round_
        self.type_ = type_
        self.val_set = val_set
        self._mtx = threading.RLock()
        self._votes_bit_array = BitArray(val_set.size())
        self._votes: list[Vote | None] = [None] * val_set.size()
        self._sum = 0
        self._maj23: BlockID | None = None
        self._votes_by_block: dict[bytes, _BlockVotes] = {}
        self._peer_maj23s: dict[str, BlockID] = {}
        # sign-bytes memo: every vote in this set at the same block id
        # shares ONE canonical payload (identity is excluded from sign
        # bytes), so a 400-validator quorum costs one serialization, not
        # 400. Small cap — adversarial distinct-block spam must not pin
        # memory (each entry is ~200 B; honest rounds see 1-2 blocks)
        self._sb_cache: dict[bytes, bytes] = {}
        self._sb_cache_cap = 8

    def size(self) -> int:
        return self.val_set.size()

    # -- adding votes ------------------------------------------------------

    def add_vote(self, vote: Vote, verifier=None) -> bool:
        """Returns True if the vote was added, False for a duplicate.
        Raises VoteError subclasses otherwise (the reference's error
        taxonomy, types/vote_set.go:120-126).

        verifier: callable(pubkey, msg, sig) -> bool; defaults to the
        key's CPU verify. The consensus layer passes the gateway's
        single-item interface, so replayed and gossiped votes take the
        same path. Composed from the split halves, so batched and
        sequential insertion cannot diverge."""
        pending = self.begin_add(vote)
        if pending is None:
            return False  # exact duplicate
        if verifier is not None:
            ok = verifier(*pending.item())
        else:
            ok = pending.val.pub_key.verify_bytes(
                pending.sign_bytes, vote.signature
            )
        return self.commit_add(pending, ok)

    def begin_add(self, vote: Vote) -> PendingVote | None:
        """Every check add_vote runs BEFORE the signature verify:
        index/address bounds, height/round/type, the exact-duplicate
        screen (returns None — add_vote's False), the different-
        signature and missing-signature screens (raised). The returned
        entry's signature still needs a verdict before commit_add."""
        with self._mtx:
            return self._begin_add(vote)

    def _begin_add(self, vote: Vote) -> PendingVote | None:
        val_index = vote.validator_index
        val_addr = vote.validator_address
        block_key = vote.block_id.key()

        if val_index < 0 or len(val_addr) == 0:
            raise ValueError("validator index/address not set in vote")

        if (
            vote.height != self.height
            or vote.round_ != self.round_
            or vote.type_ != self.type_
        ):
            raise UnexpectedStepError(
                f"expected {self.height}/{self.round_}/{self.type_}, "
                f"got {vote.height}/{vote.round_}/{vote.type_}"
            )

        lookup_addr, val = self.val_set.get_by_index(val_index)
        if val is None:
            raise InvalidValidatorIndexError(str(val_index))
        if val_addr != lookup_addr:
            raise InvalidValidatorAddressError(val_addr.hex())

        existing = self._get_vote(val_index, block_key)
        if existing is not None:
            if existing.signature == vote.signature:
                return None  # exact duplicate
            # same H/R/S/block but different signature: invalid, since
            # ed25519 signing is deterministic
            raise InvalidSignatureError("different signature for same vote")

        if vote.signature is None:
            raise InvalidSignatureError("missing signature")
        sign_bytes = self._sb_cache.get(block_key)
        if sign_bytes is None:
            sign_bytes = vote.sign_bytes(self.chain_id)
            self._sb_cache[block_key] = sign_bytes
            while len(self._sb_cache) > self._sb_cache_cap:
                self._sb_cache.pop(next(iter(self._sb_cache)))
        return PendingVote(self, vote, val, sign_bytes, block_key)

    def commit_add(self, pending: PendingVote, ok: bool) -> bool:
        """Apply a pending entry's signature verdict. Error taxonomy is
        add_vote's: a failed verdict raises InvalidSignatureError for
        THIS vote only, a conflict raises ConflictingVotesError. The
        duplicate screen re-runs under the lock so an interleaved add of
        the same vote degrades to add_vote's False, never a crash."""
        vote = pending.vote
        if not ok:
            raise InvalidSignatureError(repr(vote))
        with self._mtx:
            existing = self._get_vote(vote.validator_index, pending.block_key)
            if existing is not None:
                if existing.signature == vote.signature:
                    return False  # duplicate landed between begin and commit
                raise InvalidSignatureError("different signature for same vote")
            added, conflicting = self._add_verified_vote(
                vote, pending.block_key, pending.val.voting_power
            )
        if conflicting is not None:
            raise ConflictingVotesError(conflicting, vote)
        if not added:
            raise RuntimeError("expected to add non-conflicting vote")
        return True

    def _get_vote(self, val_index: int, block_key: bytes) -> Vote | None:
        existing = self._votes[val_index]
        if existing is not None and existing.block_id.key() == block_key:
            return existing
        bv = self._votes_by_block.get(block_key)
        if bv is not None:
            return bv.get_by_index(val_index)
        return None

    def _add_verified_vote(
        self, vote: Vote, block_key: bytes, voting_power: int
    ) -> tuple[bool, Vote | None]:
        """types/vote_set.go:209-280, preserved case-for-case."""
        val_index = vote.validator_index
        conflicting: Vote | None = None

        existing = self._votes[val_index]
        if existing is not None:
            # different block: conflict (duplicates were screened above)
            conflicting = existing
            # replace canonical vote if the new one is for the maj23 block
            if self._maj23 is not None and self._maj23.key() == block_key:
                self._votes[val_index] = vote
                self._votes_bit_array.set_index(val_index, True)
        else:
            self._votes[val_index] = vote
            self._votes_bit_array.set_index(val_index, True)
            self._sum += voting_power

        bv = self._votes_by_block.get(block_key)
        if bv is not None:
            if conflicting is not None and not bv.peer_maj23:
                # conflict and no peer claims this block is special: reject
                return False, conflicting
        else:
            if conflicting is not None:
                # not tracking this block and it's a conflict: forget it
                return False, conflicting
            bv = _BlockVotes(False, self.val_set.size())
            self._votes_by_block[block_key] = bv

        orig_sum = bv.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        bv.add_verified_vote(vote, voting_power)

        if orig_sum < quorum <= bv.sum and self._maj23 is None:
            self._maj23 = vote.block_id
            # promote this block's votes to canonical
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self._votes[i] = v

        return True, conflicting

    # -- peer claims -------------------------------------------------------

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims +2/3 for block_id: start tracking conflicting votes
        for that block (types/vote_set.go:284-317)."""
        with self._mtx:
            block_key = block_id.key()
            existing = self._peer_maj23s.get(peer_id)
            if existing is not None:
                return  # peer already told us something (same or different)
            self._peer_maj23s[peer_id] = block_id
            bv = self._votes_by_block.get(block_key)
            if bv is not None:
                bv.peer_maj23 = True
            else:
                self._votes_by_block[block_key] = _BlockVotes(
                    True, self.val_set.size()
                )

    # -- queries -----------------------------------------------------------

    def bit_array(self) -> BitArray:
        with self._mtx:
            return self._votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> BitArray | None:
        with self._mtx:
            bv = self._votes_by_block.get(block_id.key())
            return bv.bit_array.copy() if bv else None

    def get_by_index(self, val_index: int) -> Vote | None:
        with self._mtx:
            return self._votes[val_index]

    def get_by_address(self, address: bytes) -> Vote | None:
        with self._mtx:
            idx, val = self.val_set.get_by_address(address)
            if val is None:
                return None
            return self._votes[idx]

    def has_two_thirds_majority(self) -> bool:
        with self._mtx:
            return self._maj23 is not None

    def is_commit(self) -> bool:
        if self.type_ != VOTE_TYPE_PRECOMMIT:
            return False
        with self._mtx:
            return self._maj23 is not None

    def has_two_thirds_any(self) -> bool:
        with self._mtx:
            return self._sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        with self._mtx:
            return self._sum == self.val_set.total_voting_power()

    def two_thirds_majority(self) -> BlockID | None:
        with self._mtx:
            return self._maj23

    def make_commit(self) -> Commit:
        if self.type_ != VOTE_TYPE_PRECOMMIT:
            raise ValueError("commit requires precommit vote set")
        with self._mtx:
            if self._maj23 is None:
                raise ValueError("cannot make commit without +2/3 majority")
            return Commit(self._maj23, list(self._votes))

    def __repr__(self):
        with self._mtx:
            return (
                f"VoteSet{{H:{self.height} R:{self.round_} T:{self.type_} "
                f"+2/3:{self._maj23!r} {self._votes_bit_array!r}}}"
            )
