"""RoundStepType + RoundState: the consensus-internal state snapshot
(reference: consensus/state.go:45-106)."""

from __future__ import annotations


class RoundStep:
    NEW_HEIGHT = 1  # wait til commit_time + timeout_commit
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8

    _NAMES = {
        1: "NewHeight",
        2: "NewRound",
        3: "Propose",
        4: "Prevote",
        5: "PrevoteWait",
        6: "Precommit",
        7: "PrecommitWait",
        8: "Commit",
    }

    @classmethod
    def name(cls, step: int) -> str:
        return f"RoundStep{cls._NAMES.get(step, '?')}"


class RoundState:
    """Mutable snapshot owned by the receive routine; readers get copies
    via ConsensusState.get_round_state()."""

    def __init__(self):
        self.height = 0
        self.round_ = 0
        self.step = RoundStep.NEW_HEIGHT
        self.start_time = 0.0
        self.commit_time = 0.0  # wall time when +2/3 commit was found
        self.validators = None  # ValidatorSet
        self.proposal = None  # Proposal | None
        self.proposal_block = None  # Block | None
        self.proposal_block_parts = None  # PartSet | None
        self.locked_round = -1
        self.locked_block = None
        self.locked_block_parts = None
        self.votes = None  # HeightVoteSet
        self.commit_round = -1
        self.last_commit = None  # VoteSet of last height's precommits
        self.last_validators = None  # ValidatorSet
        # a VERIFIED AggregateCommit for this height, received via the
        # catchup gossip path (AggregateCommitMessage): under the
        # aggregate commit format individual precommits cannot be
        # re-gossiped, so a lagging node finalizes from this proof
        # instead of a +2/3 VoteSet (consensus/state.apply_commit_proof)
        self.commit_proof = None  # AggregateCommit | None

    def round_state_event(self):
        from tendermint_tpu_torch.types.events import EventDataRoundState

        return EventDataRoundState(
            height=self.height, round_=self.round_, step=RoundStep.name(self.step)
        )

    def to_json(self):
        return {
            "height": self.height,
            "round": self.round_,
            "step": self.step,
            "start_time": self.start_time,
            "proposal": self.proposal.to_json() if self.proposal else None,
            "locked_round": self.locked_round,
            "locked_block_hash": (
                self.locked_block.hash().hex().upper() if self.locked_block else ""
            ),
            "votes": self.votes.to_json() if self.votes else None,
        }

    def __repr__(self):
        return f"RoundState{{{self.height}/{self.round_}/{RoundStep.name(self.step)}}}"
