"""TM → ABCI type conversion (reference: types/protobuf.go TM2PB)."""

from __future__ import annotations

from tendermint_tpu_torch.abci.types import ABCIValidator, Header as ABCIHeader


def tm2pb_header(header) -> ABCIHeader:
    """types/protobuf.go:12-22."""
    return ABCIHeader(
        chain_id=header.chain_id,
        height=header.height,
        time_ns=header.time_ns,
        num_txs=header.num_txs,
        app_hash=header.app_hash,
    )


def tm2pb_validator(val) -> ABCIValidator:
    """types/protobuf.go:40-45 (Validator -> abci diff entry)."""
    return ABCIValidator(pub_key_json=val.pub_key.to_json(), power=val.voting_power)


def tm2pb_validators(genesis_validators) -> list[ABCIValidator]:
    """Genesis validator list for InitChain (consensus/replay.go:237-240)."""
    return [
        ABCIValidator(pub_key_json=v.pub_key.to_json(), power=v.power)
        for v in genesis_validators
    ]
