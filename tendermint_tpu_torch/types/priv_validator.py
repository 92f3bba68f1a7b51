"""PrivValidator: the validator's signing key with double-sign prevention
(reference: types/priv_validator.go).

Safety invariant kept from the reference (signBytesHRS, lines 225-275):
the last (height, round, step) + signature + sign-bytes are persisted to
disk ATOMICALLY BEFORE any signature is returned, so a crash-and-restart
can never produce two different signatures for the same HRS. Replaying the
same sign-bytes at the same HRS returns the saved signature (WAL replay
idempotence, consensus/replay.go:139-141).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading

from tendermint_tpu_torch.crypto.keys import (
    PrivKeyEd25519,
    PubKeyEd25519,
    SignatureEd25519,
    gen_priv_key_ed25519,
    priv_key_from_json,
    signature_from_json,
)
from tendermint_tpu_torch.types.heartbeat import Heartbeat
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, VOTE_TYPE_PREVOTE, Vote

STEP_NONE = 0
STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3


def vote_to_step(vote: Vote) -> int:
    if vote.type_ == VOTE_TYPE_PREVOTE:
        return STEP_PREVOTE
    if vote.type_ == VOTE_TYPE_PRECOMMIT:
        return STEP_PRECOMMIT
    raise ValueError(f"unknown vote type {vote.type_}")


class DoubleSignError(Exception):
    pass


class PrivValidator:
    """Interface: GetAddress/GetPubKey/SignVote/SignProposal/SignHeartbeat
    (types/priv_validator.go:39-46)."""

    def get_address(self) -> bytes:
        raise NotImplementedError

    def get_pub_key(self) -> PubKeyEd25519:
        raise NotImplementedError

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        raise NotImplementedError

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        raise NotImplementedError

    def sign_heartbeat(self, chain_id: str, heartbeat: Heartbeat) -> Heartbeat:
        raise NotImplementedError


class PrivValidatorFS(PrivValidator):
    def __init__(self, priv_key: PrivKeyEd25519, file_path: str | None):
        self.priv_key = priv_key
        self.pub_key = priv_key.pub_key()
        self.address = self.pub_key.address()
        self.last_height = 0
        self.last_round = 0
        self.last_step = STEP_NONE
        self.last_signature: SignatureEd25519 | None = None
        self.last_sign_bytes: bytes | None = None
        self.file_path = file_path
        self._mtx = threading.Lock()

    # -- construction / persistence ---------------------------------------

    @classmethod
    def generate(cls, file_path: str | None = None) -> "PrivValidatorFS":
        return cls(gen_priv_key_ed25519(), file_path)

    @classmethod
    def load(cls, file_path: str) -> "PrivValidatorFS":
        with open(file_path) as f:
            obj = json.load(f)
        pv = cls(priv_key_from_json(obj["priv_key"]), file_path)
        pv.last_height = obj.get("last_height", 0)
        pv.last_round = obj.get("last_round", 0)
        pv.last_step = obj.get("last_step", STEP_NONE)
        if obj.get("last_signature"):
            pv.last_signature = signature_from_json(obj["last_signature"])
        if obj.get("last_signbytes"):
            pv.last_sign_bytes = bytes.fromhex(obj["last_signbytes"])
        return pv

    @classmethod
    def load_or_generate(cls, file_path: str) -> "PrivValidatorFS":
        if os.path.exists(file_path):
            return cls.load(file_path)
        pv = cls.generate(file_path)
        pv.save()
        return pv

    def to_json(self):
        return {
            "address": self.address.hex().upper(),
            "pub_key": self.pub_key.to_json(),
            "last_height": self.last_height,
            "last_round": self.last_round,
            "last_step": self.last_step,
            "last_signature": self.last_signature.to_json()
            if self.last_signature
            else None,
            "last_signbytes": self.last_sign_bytes.hex().upper()
            if self.last_sign_bytes
            else None,
            "priv_key": self.priv_key.to_json(),
        }

    def save(self) -> None:
        with self._mtx:
            self._save()

    def _save(self) -> None:
        """Atomic write + fsync before returning — the double-sign guard's
        durability requirement (types/priv_validator.go:163-183)."""
        if not self.file_path:
            raise RuntimeError("cannot save PrivValidator: file_path not set")
        data = json.dumps(self.to_json(), indent=2).encode()
        d = os.path.dirname(self.file_path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".privval-")
        try:
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, self.file_path)

    def reset(self) -> None:
        """Unsafe: forget last-sign state (types/priv_validator.go:188-196)."""
        self.last_height = 0
        self.last_round = 0
        self.last_step = STEP_NONE
        self.last_signature = None
        self.last_sign_bytes = None
        if self.file_path:
            self.save()

    # -- PrivValidator interface ------------------------------------------

    def get_address(self) -> bytes:
        return self.address

    def get_pub_key(self) -> PubKeyEd25519:
        return self.pub_key

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        with self._mtx:
            sig = self._sign_bytes_hrs(
                vote.height, vote.round_, vote_to_step(vote), vote.sign_bytes(chain_id)
            )
        return vote.with_signature(sig)

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        with self._mtx:
            sig = self._sign_bytes_hrs(
                proposal.height,
                proposal.round_,
                STEP_PROPOSE,
                proposal.sign_bytes(chain_id),
            )
        return proposal.with_signature(sig)

    def sign_heartbeat(self, chain_id: str, heartbeat: Heartbeat) -> Heartbeat:
        # heartbeats carry no double-sign risk: signed without HRS tracking
        # (types/priv_validator.go SignHeartbeat)
        return heartbeat.with_signature(
            self.priv_key.sign(heartbeat.sign_bytes(chain_id))
        )

    def _sign_bytes_hrs(
        self, height: int, round_: int, step: int, sign_bytes: bytes
    ) -> SignatureEd25519:
        """types/priv_validator.go:225-275, case-for-case."""
        if self.last_height > height:
            raise DoubleSignError("height regression")
        if self.last_height == height:
            if self.last_round > round_:
                raise DoubleSignError("round regression")
            if self.last_round == round_:
                if self.last_step > step:
                    raise DoubleSignError("step regression")
                if self.last_step == step:
                    if self.last_sign_bytes is not None:
                        if self.last_signature is None:
                            raise RuntimeError(
                                "LastSignature nil but LastSignBytes is not"
                            )
                        if self.last_sign_bytes == sign_bytes:
                            # idempotent replay of the same payload
                            return self.last_signature
                    raise DoubleSignError("step regression (conflicting payload)")

        sig = self.priv_key.sign(sign_bytes)
        self.last_height = height
        self.last_round = round_
        self.last_step = step
        self.last_signature = sig
        self.last_sign_bytes = sign_bytes
        if self.file_path:
            self._save()
        return sig
