"""GenesisDoc: chain bootstrap document (reference: types/genesis.go)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from tendermint_tpu_torch.crypto.keys import PubKeyEd25519, pub_key_from_json
from tendermint_tpu_torch.types.params import ConsensusParams


@dataclass
class GenesisValidator:
    pub_key: PubKeyEd25519
    power: int
    name: str = ""

    def to_json(self):
        return {"pub_key": self.pub_key.to_json(), "power": self.power, "name": self.name}

    @classmethod
    def from_json(cls, obj) -> "GenesisValidator":
        return cls(pub_key_from_json(obj["pub_key"]), obj["power"], obj.get("name", ""))


# commit wire formats (docs/committee.md): "full" = the
# reference Commit (one signed vote per validator); "aggregate" = the
# half-aggregated prototype (types/agg_commit.py). A format flag in
# GENESIS, not config: every node of a chain must agree or refuse —
# mixed-format nets cannot silently form (decode_commit's refusal).
COMMIT_FORMATS = ("full", "aggregate")


@dataclass
class GenesisDoc:
    genesis_time_ns: int
    chain_id: str
    validators: list[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    commit_format: str = "full"
    # Scheduled consensus-rule flip: blocks at heights >= upgrade_height
    # carry their last_commit in upgrade_format; heights below stay on
    # commit_format forever. 0 = no flip scheduled. The schedule is part
    # of the chain identity — nodes disagreeing on it refuse at the
    # handshake (p2p/node_info.py), never wedge on a later decode.
    upgrade_height: int = 0
    upgrade_format: str = ""

    def validate_and_complete(self) -> None:
        """types/genesis.go:55-84: ensure chain id, >=1 validator with
        positive power, valid consensus params."""
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        err = self.consensus_params.validate()
        if err:
            raise ValueError(err)
        if self.commit_format not in COMMIT_FORMATS:
            raise ValueError(
                f"unknown commit_format {self.commit_format!r}; "
                f"expected one of {COMMIT_FORMATS}"
            )
        if self.upgrade_height < 0:
            raise ValueError("upgrade_height must be >= 0")
        if self.upgrade_height:
            if self.upgrade_format not in COMMIT_FORMATS:
                raise ValueError(
                    f"unknown upgrade_format {self.upgrade_format!r}; "
                    f"expected one of {COMMIT_FORMATS}"
                )
            if self.upgrade_format == self.commit_format:
                raise ValueError(
                    "upgrade_format equals commit_format; drop the schedule"
                )
            if self.upgrade_height < 2:
                # height 1 carries no last_commit, so the earliest height
                # whose format can differ is 2
                raise ValueError("upgrade_height must be >= 2")
        elif self.upgrade_format:
            raise ValueError("upgrade_format set without upgrade_height")
        if not self.validators:
            raise ValueError("genesis doc must include at least one validator")
        for v in self.validators:
            if v.power <= 0:
                raise ValueError(f"validator {v.name!r} has non-positive power")

    def commit_format_at(self, height: int) -> str:
        """Wire format of the last_commit carried by the block at
        `height` (which attests height-1). Heights below the scheduled
        flip are commit_format forever; at and above, upgrade_format."""
        if self.upgrade_height and height >= self.upgrade_height:
            return self.upgrade_format
        return self.commit_format

    def aggregate_commits_at(self, height: int) -> bool:
        return self.commit_format_at(height) == "aggregate"

    def schedule_string(self) -> str:
        """Canonical one-token schedule descriptor, carried in the p2p
        handshake: `full`, or `full>aggregate@100` when a flip is set."""
        if self.upgrade_height:
            return f"{self.commit_format}>{self.upgrade_format}@{self.upgrade_height}"
        return self.commit_format

    def aggregate_commits(self) -> bool:
        """True when ANY height uses the aggregate format (genesis flag
        or scheduled flip) — the agg_commit.decode_commit gate."""
        return self.commit_format == "aggregate" or self.upgrade_format == "aggregate"

    def validator_hash(self) -> bytes:
        from tendermint_tpu_torch.types.validator import Validator
        from tendermint_tpu_torch.types.validator_set import ValidatorSet

        vs = ValidatorSet([Validator.new(v.pub_key, v.power) for v in self.validators])
        return vs.hash()

    def to_json(self):
        out = {
            "genesis_time": self.genesis_time_ns,
            "chain_id": self.chain_id,
            "validators": [v.to_json() for v in self.validators],
            "app_hash": self.app_hash.hex().upper(),
            "consensus_params": self.consensus_params.to_json(),
        }
        if self.commit_format != "full":
            # key present only off the default so every existing genesis
            # doc serializes byte-identically to the pre-flag format
            out["commit_format"] = self.commit_format
        if self.upgrade_height:
            out["upgrade_height"] = self.upgrade_height
            out["upgrade_format"] = self.upgrade_format
        return out

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    @classmethod
    def from_json(cls, obj) -> "GenesisDoc":
        doc = cls(
            genesis_time_ns=obj.get("genesis_time", 0),
            chain_id=obj["chain_id"],
            validators=[GenesisValidator.from_json(v) for v in obj.get("validators", [])],
            app_hash=bytes.fromhex(obj.get("app_hash", "")),
            consensus_params=ConsensusParams.from_json(obj.get("consensus_params")),
            commit_format=obj.get("commit_format", "full"),
            upgrade_height=obj.get("upgrade_height", 0),
            upgrade_format=obj.get("upgrade_format", ""),
        )
        doc.validate_and_complete()
        return doc

    @classmethod
    def from_file(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(json.load(f))
