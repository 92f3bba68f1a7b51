"""State: the last-committed chain state (reference: state/state.go).

Persisted per height with a validator-set history: when the set changes at
height H (via EndBlock diffs) the full set is stored under H, otherwise
only a pointer to the last-changed height (saveValidatorsInfo,
state/state.go:196-210). ABCIResponses are saved BEFORE app Commit so a
crash between app-Commit and state-Save is recoverable by replaying them
(the reference's handshake case at consensus/replay.go:280-295).
"""

from __future__ import annotations

import json
import threading

from tendermint_tpu_torch.libs.db import DB
from tendermint_tpu_torch.types import (
    BlockID,
    GenesisDoc,
    Validator,
    ValidatorSet,
)
from tendermint_tpu_torch.types.block_id import PartSetHeader

_STATE_KEY = b"stateKey"
_ABCI_RESPONSES_KEY = b"abciResponsesKey"


def _validators_key(height: int) -> bytes:
    return b"validatorsKey:%d" % height


class NoValSetForHeightError(Exception):
    pass


class ABCIResponses:
    """Responses of the ABCI calls during block processing
    (state/state.go:215-239)."""

    def __init__(self, height: int, deliver_tx: list, end_block, txs: list[bytes]):
        self.height = height
        self.deliver_tx = deliver_tx
        self.end_block = end_block
        self.txs = txs

    @classmethod
    def for_block(cls, block) -> "ABCIResponses":
        return cls(block.header.height, [None] * len(block.data.txs), None, block.data.txs)

    def to_json(self):
        from tendermint_tpu_torch.abci.types import ResponseEndBlock

        return {
            "height": self.height,
            "deliver_tx": [d.to_json() if d else None for d in self.deliver_tx],
            "end_block": (self.end_block or ResponseEndBlock()).to_json(),
        }

    @classmethod
    def from_json(cls, obj) -> "ABCIResponses":
        from tendermint_tpu_torch.abci.types import ResponseDeliverTx, ResponseEndBlock

        return cls(
            obj["height"],
            [ResponseDeliverTx.from_json(d) if d else None for d in obj["deliver_tx"]],
            ResponseEndBlock.from_json(obj["end_block"]),
            [],
        )

    def bytes_(self) -> bytes:
        return json.dumps(self.to_json(), sort_keys=True).encode()


class State:
    def __init__(self, db: DB, genesis_doc: GenesisDoc, tx_indexer=None):
        from tendermint_tpu_torch.state.txindex import NullTxIndexer

        self.db = db
        self.genesis_doc = genesis_doc
        self.chain_id = genesis_doc.chain_id
        self.last_block_height = 0
        self.last_block_id = BlockID()
        self.last_block_time_ns = genesis_doc.genesis_time_ns
        self.validators: ValidatorSet = ValidatorSet([])
        self.last_validators: ValidatorSet = ValidatorSet([])
        self.app_hash = b""
        self.last_height_validators_changed = 1
        self.tx_indexer = tx_indexer or NullTxIndexer()
        self._mtx = threading.Lock()

    # -- constructors ------------------------------------------------------

    @classmethod
    def make_genesis_state(cls, db: DB, genesis_doc: GenesisDoc) -> "State":
        genesis_doc.validate_and_complete()
        s = cls(db, genesis_doc)
        s.validators = ValidatorSet(
            [Validator.new(v.pub_key, v.power) for v in genesis_doc.validators]
        )
        s.last_validators = ValidatorSet([])
        s.app_hash = genesis_doc.app_hash
        return s

    @classmethod
    def from_json_obj(cls, db: DB, genesis_doc: GenesisDoc, obj: dict) -> "State":
        """Rehydrate a State from its to_json() form — the load_state
        body, also used by the statesync restore path on a snapshot's
        embedded state object."""
        s = cls(db, genesis_doc)
        s.last_block_height = obj["last_block_height"]
        s.last_block_id = BlockID.from_json(obj["last_block_id"])
        s.last_block_time_ns = obj["last_block_time"]
        s.validators = ValidatorSet.from_json(obj["validators"])
        s.last_validators = ValidatorSet.from_json(obj["last_validators"])
        s.app_hash = bytes.fromhex(obj["app_hash"])
        s.last_height_validators_changed = obj["last_height_validators_changed"]
        return s

    @classmethod
    def load_state(cls, db: DB, genesis_doc: GenesisDoc) -> "State | None":
        buf = db.get(_STATE_KEY)
        if not buf:
            return None
        return cls.from_json_obj(db, genesis_doc, json.loads(buf))

    @classmethod
    def get_state(cls, db: DB, genesis_doc: GenesisDoc) -> "State":
        """LoadState-or-genesis (state/state.go:71-84)."""
        s = cls.load_state(db, genesis_doc)
        if s is None:
            s = cls.make_genesis_state(db, genesis_doc)
            s.save()
        return s

    def copy(self) -> "State":
        s = State(self.db, self.genesis_doc, self.tx_indexer)
        s.last_block_height = self.last_block_height
        s.last_block_id = self.last_block_id
        s.last_block_time_ns = self.last_block_time_ns
        s.validators = self.validators.copy()
        s.last_validators = self.last_validators.copy()
        s.app_hash = self.app_hash
        s.last_height_validators_changed = self.last_height_validators_changed
        return s

    # -- persistence -------------------------------------------------------

    def to_json(self):
        return {
            "chain_id": self.chain_id,
            "last_block_height": self.last_block_height,
            "last_block_id": self.last_block_id.to_json(),
            "last_block_time": self.last_block_time_ns,
            "validators": self.validators.to_json(),
            "last_validators": self.last_validators.to_json(),
            "app_hash": self.app_hash.hex().upper(),
            "last_height_validators_changed": self.last_height_validators_changed,
        }

    def bytes_(self) -> bytes:
        return json.dumps(self.to_json(), sort_keys=True).encode()

    def save(self) -> None:
        with self._mtx:
            self._save_validators_info()
            self.db.set_sync(_STATE_KEY, self.bytes_())

    def _save_validators_info(self) -> None:
        """Full set if it changed at next height, else pointer only
        (state/state.go:196-210)."""
        next_height = self.last_block_height + 1
        info = {"last_height_changed": self.last_height_validators_changed}
        if self.last_height_validators_changed == next_height:
            info["validator_set"] = self.validators.to_json()
        self.db.set_sync(_validators_key(next_height), json.dumps(info, sort_keys=True).encode())

    def load_validators(self, height: int) -> ValidatorSet:
        """Validator set that signed at `height`, following last-changed
        pointers (state/state.go:162-194)."""
        info = self._load_validators_info(height)
        if info is None:
            raise NoValSetForHeightError(str(height))
        if "validator_set" not in info:
            info = self._load_validators_info(info["last_height_changed"])
            if info is None or "validator_set" not in info:
                raise NoValSetForHeightError(str(height))
        return ValidatorSet.from_json(info["validator_set"])

    def _load_validators_info(self, height: int):
        buf = self.db.get(_validators_key(height))
        if not buf:
            return None
        return json.loads(buf)

    def save_abci_responses(self, responses: ABCIResponses) -> None:
        self.db.set_sync(_ABCI_RESPONSES_KEY, responses.bytes_())

    def load_abci_responses(self) -> ABCIResponses | None:
        buf = self.db.get(_ABCI_RESPONSES_KEY)
        if not buf:
            return None
        return ABCIResponses.from_json(json.loads(buf))

    # -- updates -----------------------------------------------------------

    def set_block_and_validators(self, header, block_parts_header: PartSetHeader, abci_responses: ABCIResponses) -> None:
        """Apply EndBlock valset diffs, rotate proposer, advance last-block
        pointers (state/state.go:223-260)."""
        from tendermint_tpu_torch.state.execution import update_validators

        prev_val_set = self.validators.copy()
        next_val_set = prev_val_set.copy()

        diffs = abci_responses.end_block.diffs if abci_responses.end_block else []
        if diffs:
            update_validators(next_val_set, diffs)
            self.last_height_validators_changed = header.height + 1

        next_val_set.increment_accum(1)

        self.last_block_height = header.height
        self.last_block_id = BlockID(header.hash(), block_parts_header)
        self.last_block_time_ns = header.time_ns
        self.validators = next_val_set
        self.last_validators = prev_val_set

    def params(self):
        return self.genesis_doc.consensus_params

    def seed_restored(self, validators_info: dict) -> None:
        """Statesync restore: persist this (light-verified) state as THE
        state, plus the validator-history records load_validators needs
        for heights at/after the snapshot (statesync/producer.py
        validators_info_records). The caller verified every record's set
        against the header chain before handing it here."""
        with self._mtx:
            for h_str, info in validators_info.items():
                self.db.set_sync(
                    _validators_key(int(h_str)),
                    json.dumps(info, sort_keys=True).encode(),
                )
            self.db.set_sync(_STATE_KEY, self.bytes_())

    def equals(self, other: "State") -> bool:
        return self.bytes_() == other.bytes_()

    def __repr__(self):
        return (
            f"State{{h:{self.last_block_height} vals:{self.validators.size()} "
            f"app:{self.app_hash.hex()[:12]}}}"
        )
