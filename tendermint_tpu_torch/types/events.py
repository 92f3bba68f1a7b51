"""Event taxonomy + payloads + fire helpers (reference: types/events.go).

Event strings are the pub/sub keys on the EventSwitch; the consensus
reactor and RPC WebSocket manager subscribe by these names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from tendermint_tpu_torch.libs.events import Fireable

# -- event names (types/events.go:14-46) ------------------------------------

EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_POLKA = "Polka"
EVENT_UNLOCK = "Unlock"
EVENT_LOCK = "Lock"
EVENT_RELOCK = "Relock"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_VOTE = "Vote"
EVENT_PROPOSAL_HEARTBEAT = "ProposalHeartbeat"
# beyond reference: fired when the proposal part-set gains a part
# (build or gossip) — the consensus reactor broadcasts a HasBlockPart
# announcement off it so peers stop re-sending parts we already hold
# (the part-gossip dedup screen)
EVENT_PROPOSAL_BLOCK_PART = "ProposalBlockPart"
# beyond reference: fired when duplicate-vote evidence is validated and
# pooled (types/evidence.py; the reference detects conflicts and punts,
# consensus/state.go:1438-1447)
EVENT_EVIDENCE = "Evidence"


def event_string_tx(tx_hash: bytes) -> str:
    """Per-tx event key (types/events.go EventStringTx): lets
    broadcast_tx_commit wait for exactly its own tx."""
    return f"Tx:{tx_hash.hex().upper()}"


# -- payloads (types/events.go:105-145) --------------------------------------


@dataclass
class EventDataNewBlock:
    block: Any

    def to_json(self):
        return {"block": self.block.to_json()}


@dataclass
class EventDataNewBlockHeader:
    header: Any

    def to_json(self):
        return {"header": self.header.to_json()}


@dataclass
class EventDataTx:
    height: int
    tx: bytes
    data: bytes
    log: str
    code: int
    error: str = ""

    def to_json(self):
        return {
            "height": self.height,
            "tx": self.tx.hex().upper(),
            "data": (self.data or b"").hex().upper(),
            "log": self.log,
            "code": self.code,
            "error": self.error,
        }


@dataclass
class EventDataRoundState:
    height: int
    round_: int
    step: str
    round_state: Any = None  # full RoundState for internal subscribers

    def to_json(self):
        return {"height": self.height, "round": self.round_, "step": self.step}


@dataclass
class EventDataVote:
    vote: Any

    def to_json(self):
        return {"vote": self.vote.to_json()}


@dataclass
class EventDataBlockPart:
    height: int
    round_: int
    index: int

    def to_json(self):
        return {"height": self.height, "round": self.round_, "index": self.index}


@dataclass
class EventDataProposalHeartbeat:
    heartbeat: Any

    def to_json(self):
        return {"heartbeat": self.heartbeat.to_json()}


# -- fire helpers (types/events.go:190-251) ----------------------------------


def fire_event_new_block(evsw: Fireable, block) -> None:
    evsw.fire_event(EVENT_NEW_BLOCK, EventDataNewBlock(block))


def fire_event_new_block_header(evsw: Fireable, header) -> None:
    evsw.fire_event(EVENT_NEW_BLOCK_HEADER, EventDataNewBlockHeader(header))


def fire_event_vote(evsw: Fireable, vote) -> None:
    evsw.fire_event(EVENT_VOTE, EventDataVote(vote))


def fire_event_tx(evsw: Fireable, data: EventDataTx) -> None:
    evsw.fire_event(event_string_tx_from_data(data), data)


def event_string_tx_from_data(data: EventDataTx) -> str:
    from tendermint_tpu_torch.types.tx import tx_hash

    return event_string_tx(tx_hash(data.tx))
