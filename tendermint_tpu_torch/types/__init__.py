"""Consensus data model (reference: types/): blocks, votes, validator
sets, commits (full and aggregate), part sets, transactions, proposals,
genesis docs, the priv-validator signing guard and the event taxonomy,
and the ABCI bridge of validators and headers (`types.protobuf`).
Everything signed or hashed routes through codec.canonical / codec.binary,
so the port's bytes equal the JAX package's."""

from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
from tendermint_tpu_torch.types.part_set import Part, PartSet
from tendermint_tpu_torch.types.vote import (
    ConflictingVotesError,
    VOTE_TYPE_PRECOMMIT,
    VOTE_TYPE_PREVOTE,
    Vote,
    VoteError,
)
from tendermint_tpu_torch.types.tx import Tx, TxProof, TxResult, txs_hash, txs_proof
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.block import Block, Commit, Data, Header
from tendermint_tpu_torch.types.vote_set import VoteSet
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.heartbeat import Heartbeat
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.priv_validator import PrivValidator, PrivValidatorFS

__all__ = [
    "BlockID",
    "PartSetHeader",
    "Part",
    "PartSet",
    "Vote",
    "VoteError",
    "ConflictingVotesError",
    "VOTE_TYPE_PREVOTE",
    "VOTE_TYPE_PRECOMMIT",
    "Tx",
    "TxProof",
    "TxResult",
    "txs_hash",
    "txs_proof",
    "Validator",
    "ValidatorSet",
    "Block",
    "Header",
    "Data",
    "Commit",
    "VoteSet",
    "Proposal",
    "Heartbeat",
    "ConsensusParams",
    "GenesisDoc",
    "GenesisValidator",
    "PrivValidator",
    "PrivValidatorFS",
]
