"""Consensus wire/WAL messages (reference: consensus/reactor.go:1181-1363).

A tagged-union JSON codec: each message type registers under a short tag
(the analogue of go-wire's type bytes, consensus/reactor.go:1198-1210).
The same encoding serves the WAL and the p2p channels.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.libs.bitarray import BitArray
from tendermint_tpu_torch.types import BlockID, Heartbeat, Part, Proposal, Vote
from tendermint_tpu_torch.types.block_id import PartSetHeader

_REGISTRY: dict[str, type] = {}


def register(tag: str):
    def deco(cls):
        cls.TAG = tag
        _REGISTRY[tag] = cls
        return cls

    return deco


def msg_to_json(msg) -> dict:
    return {"type": msg.TAG, "data": msg.to_json()}


def msg_from_json(obj: dict):
    """Decode one peer message. The input is attacker-controlled: the
    envelope and every scalar field are type- and range-checked here (the
    go-wire codec got this for free from typed byte decoding); anything
    out of contract raises ValueError, which the reactor's receive()
    treats as a peer error."""
    if not isinstance(obj, dict) or not isinstance(obj.get("type"), str):
        raise ValueError("malformed consensus message envelope")
    cls = _REGISTRY.get(obj["type"])
    if cls is None:
        raise ValueError(f"unknown consensus message type {obj['type']!r}")
    data = obj.get("data")
    if not isinstance(data, dict):
        raise ValueError("malformed consensus message body")
    return cls.from_json(data)


# -- field validators (attacker-facing bounds; shared with the nested
# wire types via codec/jsonval) ---------------------------------------------

from tendermint_tpu_torch.codec.jsonval import (  # noqa: E402
    MAX_HEIGHT as _MAX_HEIGHT,
    MAX_INDEX as _MAX_INDEX,
    MAX_ROUND as _MAX_ROUND,
    dict_field as _dict_field,
    int_field as _int_field,
)

_MAX_BITS = 1 << 20  # vote / part bit-arrays


def _bitarray_field(o, key, max_bits=_MAX_BITS):
    v = _dict_field(o, key)
    bits = v.get("bits")
    if type(bits) is not int or not (0 <= bits <= max_bits):
        raise ValueError(f"bad {key!r} size: {bits!r}")
    return BitArray.from_json(v)


@register("new_round_step")
@dataclass
class NewRoundStepMessage:
    """Broadcast on every step transition (consensus/reactor.go:1225-1251)."""

    height: int
    round_: int
    step: int
    seconds_since_start_time: int
    last_commit_round: int

    def to_json(self):
        return {
            "height": self.height,
            "round": self.round_,
            "step": self.step,
            "seconds_since_start_time": self.seconds_since_start_time,
            "last_commit_round": self.last_commit_round,
        }

    @classmethod
    def from_json(cls, o):
        return cls(
            _int_field(o, "height", 0, _MAX_HEIGHT),
            _int_field(o, "round", 0, _MAX_ROUND),
            _int_field(o, "step", 0, 16),
            _int_field(o, "seconds_since_start_time", -_MAX_ROUND, _MAX_ROUND),
            _int_field(o, "last_commit_round", -1, _MAX_ROUND),
        )


@register("commit_step")
@dataclass
class CommitStepMessage:
    """consensus/reactor.go:1256-1268."""

    height: int
    block_parts_header: PartSetHeader
    block_parts: BitArray

    def to_json(self):
        return {
            "height": self.height,
            "block_parts_header": self.block_parts_header.to_json(),
            "block_parts": self.block_parts.to_json(),
        }

    @classmethod
    def from_json(cls, o):
        return cls(
            _int_field(o, "height", 0, _MAX_HEIGHT),
            PartSetHeader.from_json(_dict_field(o, "block_parts_header")),
            _bitarray_field(o, "block_parts"),
        )


@register("proposal")
@dataclass
class ProposalMessage:
    proposal: Proposal

    def to_json(self):
        return {"proposal": self.proposal.to_json()}

    @classmethod
    def from_json(cls, o):
        return cls(Proposal.from_json(_dict_field(o, "proposal")))


@register("proposal_pol")
@dataclass
class ProposalPOLMessage:
    """Sent when catching a peer up to a POL round (consensus/reactor.go:1289-1300)."""

    height: int
    proposal_pol_round: int
    proposal_pol: BitArray

    def to_json(self):
        return {
            "height": self.height,
            "proposal_pol_round": self.proposal_pol_round,
            "proposal_pol": self.proposal_pol.to_json(),
        }

    @classmethod
    def from_json(cls, o):
        return cls(
            _int_field(o, "height", 0, _MAX_HEIGHT),
            _int_field(o, "proposal_pol_round", 0, _MAX_ROUND),
            _bitarray_field(o, "proposal_pol"),
        )


@register("block_part")
@dataclass
class BlockPartMessage:
    height: int
    round_: int
    part: Part

    def to_json(self):
        return {"height": self.height, "round": self.round_, "part": self.part.to_json()}

    @classmethod
    def from_json(cls, o):
        return cls(
            _int_field(o, "height", 0, _MAX_HEIGHT),
            _int_field(o, "round", 0, _MAX_ROUND),
            Part.from_json(_dict_field(o, "part")),
        )


@register("vote")
@dataclass
class VoteMessage:
    vote: Vote

    def to_json(self):
        return {"vote": self.vote.to_json()}

    @classmethod
    def from_json(cls, o):
        return cls(Vote.from_json(_dict_field(o, "vote")))


@register("has_vote")
@dataclass
class HasVoteMessage:
    """Tells peers our vote bit-arrays changed (consensus/reactor.go:1327-1339)."""

    height: int
    round_: int
    type_: int
    index: int

    def to_json(self):
        return {"height": self.height, "round": self.round_, "type": self.type_, "index": self.index}

    @classmethod
    def from_json(cls, o):
        return cls(
            _int_field(o, "height", 0, _MAX_HEIGHT),
            _int_field(o, "round", 0, _MAX_ROUND),
            _int_field(o, "type", 0, 255),
            _int_field(o, "index", 0, _MAX_INDEX),
        )


@register("has_block_part")
@dataclass
class HasBlockPartMessage:
    """Tells peers our proposal part-set gained a part (beyond
    reference): the part-gossip dedup screen. A node that just
    assembled part `index` announces it on the STATE channel so every
    OTHER peer's mirror marks the bit and its gossip_data loop skips
    re-sending a part the node already holds — without this, k peers
    holding a part all race to push it and k-1 copies are pure
    redundancy (the part-set analogue of the 2NxN vote problem)."""

    height: int
    round_: int
    index: int

    def to_json(self):
        return {"height": self.height, "round": self.round_, "index": self.index}

    @classmethod
    def from_json(cls, o):
        return cls(
            _int_field(o, "height", 0, _MAX_HEIGHT),
            _int_field(o, "round", 0, _MAX_ROUND),
            _int_field(o, "index", 0, _MAX_INDEX),
        )


@register("agg_commit")
@dataclass
class AggregateCommitMessage:
    """Catch a lagging peer up under the aggregate commit format
    (docs/upgrade.md): individual precommits no longer exist once a
    commit has been half-aggregated, so the per-vote catchup gossip
    (reactor.go:609-645) is impossible — the whole AggregateCommit
    ships instead, and the receiver finalizes from it as a commit
    proof (consensus/state.apply_commit_proof) after verifying the
    aggregate against its own validator set. A forged or sub-quorum
    aggregate is a peer error (stop_peer_for_error)."""

    height: int
    commit: object  # AggregateCommit (typed lazily: types <-/-> consensus)

    def to_json(self):
        return {"height": self.height, "commit": self.commit.to_json()}

    @classmethod
    def from_json(cls, o):
        from tendermint_tpu_torch.types.agg_commit import AggregateCommit

        return cls(
            _int_field(o, "height", 0, _MAX_HEIGHT),
            AggregateCommit.from_json(_dict_field(o, "commit")),
        )


@register("vote_set_maj23")
@dataclass
class VoteSetMaj23Message:
    """Claim of +2/3 for a block (consensus/reactor.go:1344-1355)."""

    height: int
    round_: int
    type_: int
    block_id: BlockID

    def to_json(self):
        return {
            "height": self.height,
            "round": self.round_,
            "type": self.type_,
            "block_id": self.block_id.to_json(),
        }

    @classmethod
    def from_json(cls, o):
        return cls(
            _int_field(o, "height", 0, _MAX_HEIGHT),
            _int_field(o, "round", 0, _MAX_ROUND),
            _int_field(o, "type", 0, 255),
            BlockID.from_json(_dict_field(o, "block_id")),
        )


@register("vote_set_bits")
@dataclass
class VoteSetBitsMessage:
    """Response to VoteSetMaj23: which of those votes we have
    (consensus/reactor.go:1360-1372)."""

    height: int
    round_: int
    type_: int
    block_id: BlockID
    votes: BitArray

    def to_json(self):
        return {
            "height": self.height,
            "round": self.round_,
            "type": self.type_,
            "block_id": self.block_id.to_json(),
            "votes": self.votes.to_json(),
        }

    @classmethod
    def from_json(cls, o):
        return cls(
            _int_field(o, "height", 0, _MAX_HEIGHT),
            _int_field(o, "round", 0, _MAX_ROUND),
            _int_field(o, "type", 0, 255),
            BlockID.from_json(_dict_field(o, "block_id")),
            _bitarray_field(o, "votes"),
        )


@register("proposal_heartbeat")
@dataclass
class ProposalHeartbeatMessage:
    heartbeat: Heartbeat

    def to_json(self):
        return {"heartbeat": self.heartbeat.to_json()}

    @classmethod
    def from_json(cls, o):
        return cls(Heartbeat.from_json(_dict_field(o, "heartbeat")))
