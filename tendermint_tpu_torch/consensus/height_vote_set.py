"""HeightVoteSet: all prevote/precommit VoteSets for one height
(reference: consensus/height_vote_set.go).

Keeps both vote types for rounds 0..round, plus up to 2 "catchup" rounds
created when a peer sends votes for future rounds (DOS bound,
consensus/height_vote_set.go:18-24,118-139). POL lookup scans rounds for
a prevote +2/3 (consensus/height_vote_set.go:143-153).
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.types import (
    VOTE_TYPE_PRECOMMIT,
    VOTE_TYPE_PREVOTE,
    BlockID,
    ValidatorSet,
    Vote,
    VoteSet,
)

MAX_CATCHUP_ROUNDS = 2

# begin_add's distinguishable drop: a vote for a round this
# set refuses to track (catchup budget spent) is NOT an already-seen
# duplicate — the redundancy counters must only count true re-deliveries
UNWANTED_ROUND = object()


class _RoundVoteSet:
    __slots__ = ("prevotes", "precommits")

    def __init__(self, prevotes: VoteSet, precommits: VoteSet):
        self.prevotes = prevotes
        self.precommits = precommits


class HeightVoteSet:
    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self._mtx = threading.RLock()
        self._round = 0
        self._round_vote_sets: dict[int, _RoundVoteSet] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        self._add_round(0)

    def round(self) -> int:
        with self._mtx:
            return self._round

    def _add_round(self, round_: int) -> None:
        if round_ in self._round_vote_sets:
            raise RuntimeError(f"add_round for existing round {round_}")
        self._round_vote_sets[round_] = _RoundVoteSet(
            VoteSet(self.chain_id, self.height, round_, VOTE_TYPE_PREVOTE, self.val_set),
            VoteSet(self.chain_id, self.height, round_, VOTE_TYPE_PRECOMMIT, self.val_set),
        )

    def set_round(self, round_: int) -> None:
        """Create vote sets through round+1 (the reference seeds one round
        ahead, consensus/height_vote_set.go:84-103)."""
        with self._mtx:
            if self._round != 0 and round_ < self._round:
                raise RuntimeError("set_round must increase round")
            for r in range(self._round, round_ + 2):
                if r not in self._round_vote_sets:
                    self._add_round(r)
            self._round = round_

    # -- votes -------------------------------------------------------------

    def add_vote(self, vote: Vote, peer_id: str = "", verifier=None) -> bool:
        """consensus/height_vote_set.go:105-116. Returns True if added.
        Raises VoteError for invalid votes; votes for unwanted rounds from
        peers beyond the catchup budget are silently dropped (returns
        False, mirroring ErrGotVoteFromUnwantedRound)."""
        with self._mtx:
            vs = self._resolve_vote_set(vote, peer_id)
            if vs is None:
                return False
        return vs.add_vote(vote, verifier=verifier)

    def begin_add(self, vote: Vote, peer_id: str = ""):
        """Split-add entry (types/vote_set.py PendingVote):
        resolves the round's VoteSet — creating a catchup round within
        the per-peer budget exactly as add_vote would — and runs its
        structural half. None = exact duplicate (add_vote's False);
        the UNWANTED_ROUND sentinel = dropped untracked-round vote
        (also add_vote's False, but NOT a gossip re-delivery — the
        duplicate counters key off the distinction); commit
        via the returned entry's .commit(ok)."""
        with self._mtx:
            vs = self._resolve_vote_set(vote, peer_id)
            if vs is None:
                return UNWANTED_ROUND
        return vs.begin_add(vote)

    def _resolve_vote_set(self, vote: Vote, peer_id: str):
        """The add-side round lookup + catchup-budget bookkeeping
        (callers hold self._mtx)."""
        if not self._is_vote_type_tracked(vote.type_):
            return None
        vs = self._get_vote_set(vote.round_, vote.type_)
        if vs is None:
            rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
            if len(rounds) < MAX_CATCHUP_ROUNDS:
                self._add_round(vote.round_)
                vs = self._get_vote_set(vote.round_, vote.type_)
                rounds.append(vote.round_)
            else:
                return None  # punish peer?
        return vs

    @staticmethod
    def _is_vote_type_tracked(t: int) -> bool:
        return t in (VOTE_TYPE_PREVOTE, VOTE_TYPE_PRECOMMIT)

    def _get_vote_set(self, round_: int, type_: int) -> VoteSet | None:
        rvs = self._round_vote_sets.get(round_)
        if rvs is None:
            return None
        return rvs.prevotes if type_ == VOTE_TYPE_PREVOTE else rvs.precommits

    def prevotes(self, round_: int) -> VoteSet | None:
        with self._mtx:
            return self._get_vote_set(round_, VOTE_TYPE_PREVOTE)

    def precommits(self, round_: int) -> VoteSet | None:
        with self._mtx:
            return self._get_vote_set(round_, VOTE_TYPE_PRECOMMIT)

    def pol_info(self) -> tuple[int, BlockID | None]:
        """Highest round with a prevote +2/3, searching down from current
        (consensus/height_vote_set.go:143-153). Returns (-1, None) if none."""
        with self._mtx:
            for r in range(self._round, -1, -1):
                vs = self._get_vote_set(r, VOTE_TYPE_PREVOTE)
                if vs is not None:
                    block_id = vs.two_thirds_majority()
                    if block_id is not None:
                        return r, block_id
            return -1, None

    def set_peer_maj23(self, round_: int, type_: int, peer_id: str, block_id: BlockID) -> None:
        """consensus/height_vote_set.go:209-219."""
        with self._mtx:
            if not self._is_vote_type_tracked(type_):
                return
            vs = self._get_vote_set(round_, type_)
            if vs is not None:
                vs.set_peer_maj23(peer_id, block_id)

    def to_json(self):
        with self._mtx:
            return {
                "round": self._round,
                "round_votes": {
                    str(r): {
                        "prevotes": repr(rvs.prevotes),
                        "precommits": repr(rvs.precommits),
                    }
                    for r, rvs in sorted(self._round_vote_sets.items())
                },
            }

    def __repr__(self):
        return f"HeightVoteSet{{h:{self.height} r:{self._round}}}"
