"""Node identity and compatibility handshake data (reference: p2p/types.go).

NodeInfo is exchanged unencrypted-length-prefixed right after the secret
handshake; CompatibleWith gates the peering (p2p/types.go:25-56).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from tendermint_tpu_torch.crypto.keys import PubKeyEd25519
from tendermint_tpu_torch.version import PROTOCOL_VERSION

MAX_NODE_INFO_SIZE = 10240


@dataclass
class NodeInfo:
    pub_key: PubKeyEd25519
    moniker: str
    network: str  # chain id
    version: str  # "protocol/software", compat gated on protocol part
    remote_addr: str = ""
    listen_addr: str = ""
    channels: bytes = b""  # channel ids this node serves
    other: list = field(default_factory=list)

    def id(self) -> str:
        """Peer key: hex of the node pubkey address."""
        return self.pub_key.address().hex()

    def _commit_format(self) -> str:
        """The genesis commit-format SCHEDULE this node runs under, from
        the `other` key/value list (`commit_schedule=` carries
        the full upgrade schedule string, e.g. "full>aggregate@100" —
        genesis.schedule_string(); two nodes agreeing on today's format
        but disagreeing on the flip height would fork AT the flip, so
        the whole schedule gates the peering). Falls back to the older
        `commit_format=` flag for older peers, then to "full" — exactly
        the genesis default, so homogeneous old nets stay compatible."""
        fmt = None
        for entry in self.other:
            if not isinstance(entry, str):
                continue
            if entry.startswith("commit_schedule="):
                return entry.split("=", 1)[1]
            if entry.startswith("commit_format="):
                fmt = entry.split("=", 1)[1]
        return fmt if fmt is not None else "full"

    def compatible_with(self, other: "NodeInfo") -> str | None:
        """None if compatible, else a human-readable reason
        (p2p/types.go:28-56: same protocol version, same network; plus
        the genesis commit_format flag — a mixed-format net must
        refuse LOUDLY at the handshake, not wedge later when one side
        gossips commit bytes the other's decode_commit rejects,
        docs/committee.md)."""
        mine = self.version.split("/", 1)[0]
        theirs = other.version.split("/", 1)[0]
        if mine != theirs:
            return f"protocol version mismatch: {mine} vs {theirs}"
        if self.network != other.network:
            return f"network mismatch: {self.network} vs {other.network}"
        if self._commit_format() != other._commit_format():
            return (
                f"commit schedule mismatch: {self._commit_format()} vs "
                f"{other._commit_format()} (mixed-schedule nets refuse at "
                f"handshake, never wedge at decode; docs/upgrade.md)"
            )
        return None

    def to_json(self) -> dict:
        return {
            "pub_key": self.pub_key.to_json(),
            "moniker": self.moniker,
            "network": self.network,
            "version": self.version,
            "remote_addr": self.remote_addr,
            "listen_addr": self.listen_addr,
            "channels": self.channels.hex(),
            "other": self.other,
        }

    @classmethod
    def from_json(cls, o: dict) -> "NodeInfo":
        # handshake input from an unauthenticated peer: every field is
        # type- and size-checked; violations raise ValueError (-> the
        # switch drops the connection). The frame itself is already
        # capped at MAX_NODE_INFO_SIZE (peer.exchange_node_info).
        from tendermint_tpu_torch.codec import jsonval as jv

        o = jv.require_dict(o)
        other = o.get("other", [])
        if not isinstance(other, list) or len(other) > 32 or any(
            not isinstance(x, str) or len(x) > jv.MAX_STR for x in other
        ):
            raise ValueError("bad node info 'other'")
        return cls(
            pub_key=PubKeyEd25519.from_json(o.get("pub_key")),
            moniker=jv.str_field(o, "moniker"),
            network=jv.str_field(o, "network"),
            version=jv.str_field(o, "version"),
            remote_addr=jv.str_field(o, "remote_addr") if o.get("remote_addr") else "",
            listen_addr=jv.str_field(o, "listen_addr") if o.get("listen_addr") else "",
            channels=jv.hex_field(o, "channels", max_bytes=32) if o.get("channels") else b"",
            other=other,
        )

    def encode(self) -> bytes:
        return json.dumps(self.to_json(), sort_keys=True).encode()

    @classmethod
    def decode(cls, raw: bytes) -> "NodeInfo":
        return cls.from_json(json.loads(raw.decode()))


def default_version(software_version: str) -> str:
    return f"{PROTOCOL_VERSION}/{software_version}"
