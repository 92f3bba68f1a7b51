"""ABCI message types and the Application interface.

Mirrors the reference's abci/types surface (the v0.5-era protocol that
Tendermint v0.11 speaks): Info, SetOption, CheckTx, DeliverTx, BeginBlock,
EndBlock, Commit, Query, InitChain, Echo, Flush. Code 0 is OK; any other
code is app-defined rejection.
"""

from __future__ import annotations

from dataclasses import dataclass, field

CODE_OK = 0
CODE_BAD_NONCE = 4  # counter-app style ordering violation
CODE_UNAUTHORIZED = 3
CODE_UNSUPPORTED = 5  # query feature the app cannot serve (e.g. prove=True)
CODE_MEMPOOL_FULL = 6  # shed at a mempool lane cap / load-shed ladder


def proofs_unsupported_response(app, key: bytes) -> "ResponseQuery":
    """The CLEAR `prove=True`-against-a-non-proving-app refusal: apps without an authenticated state tree must answer with this
    instead of silently omitting the proof field — a light client that
    trusted the bare value would be reading unverified state."""
    return ResponseQuery(
        code=CODE_UNSUPPORTED,
        key=key,
        log=(
            f"proofs unsupported: {type(app).__name__} does not maintain "
            "an authenticated state tree"
        ),
    )


@dataclass
class ABCIValidator:
    """Validator diff entry for EndBlock (power 0 removes)."""

    pub_key_json: list  # typed pubkey json [type, hexbytes]
    power: int

    def to_json(self):
        return {"pub_key": self.pub_key_json, "power": self.power}

    @classmethod
    def from_json(cls, obj):
        return cls(obj["pub_key"], obj["power"])


@dataclass
class Header:
    """Minimal block header passed to BeginBlock (abci Header message)."""

    chain_id: str = ""
    height: int = 0
    time_ns: int = 0
    num_txs: int = 0
    app_hash: bytes = b""

    def to_json(self):
        return {
            "chain_id": self.chain_id,
            "height": self.height,
            "time": self.time_ns,
            "num_txs": self.num_txs,
            "app_hash": self.app_hash.hex().upper(),
        }

    @classmethod
    def from_json(cls, obj):
        return cls(
            obj.get("chain_id", ""),
            obj.get("height", 0),
            obj.get("time", 0),
            obj.get("num_txs", 0),
            bytes.fromhex(obj.get("app_hash", "")),
        )


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    last_block_height: int = 0
    last_block_app_hash: bytes = b""

    def to_json(self):
        return {
            "data": self.data,
            "version": self.version,
            "last_block_height": self.last_block_height,
            "last_block_app_hash": self.last_block_app_hash.hex().upper(),
        }

    @classmethod
    def from_json(cls, obj):
        return cls(
            obj.get("data", ""),
            obj.get("version", ""),
            obj.get("last_block_height", 0),
            bytes.fromhex(obj.get("last_block_app_hash", "")),
        )


@dataclass
class ResponseCheckTx:
    code: int = CODE_OK
    data: bytes = b""
    log: str = ""
    # app-visible priority hint: >0 routes the tx to the mempool's
    # priority lane, <0 to the bulk lane, 0 (the default) to the default
    # lane. Key-absent on the wire when 0 so pre-existing CheckTx JSON
    # stays byte-identical (same pattern as the aggregate-commit fields).
    priority: int = 0

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_OK

    def to_json(self):
        obj = {"code": self.code, "data": self.data.hex().upper(), "log": self.log}
        if self.priority:
            obj["priority"] = self.priority
        return obj

    @classmethod
    def from_json(cls, obj):
        return cls(
            obj.get("code", 0),
            bytes.fromhex(obj.get("data", "")),
            obj.get("log", ""),
            obj.get("priority", 0),
        )


@dataclass
class ResponseDeliverTx:
    code: int = CODE_OK
    data: bytes = b""
    log: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_OK

    def to_json(self):
        return {"code": self.code, "data": self.data.hex().upper(), "log": self.log}

    @classmethod
    def from_json(cls, obj):
        return cls(obj.get("code", 0), bytes.fromhex(obj.get("data", "")), obj.get("log", ""))


@dataclass
class ResponseCommit:
    code: int = CODE_OK
    data: bytes = b""  # the new app hash
    log: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_OK

    def to_json(self):
        return {"code": self.code, "data": self.data.hex().upper(), "log": self.log}

    @classmethod
    def from_json(cls, obj):
        return cls(obj.get("code", 0), bytes.fromhex(obj.get("data", "")), obj.get("log", ""))


@dataclass
class ResponseQuery:
    code: int = CODE_OK
    index: int = -1
    key: bytes = b""
    value: bytes = b""
    proof: bytes = b""
    height: int = 0
    log: str = ""

    def to_json(self):
        return {
            "code": self.code,
            "index": self.index,
            "key": self.key.hex().upper(),
            "value": self.value.hex().upper(),
            "proof": self.proof.hex().upper(),
            "height": self.height,
            "log": self.log,
        }

    @classmethod
    def from_json(cls, obj):
        return cls(
            obj.get("code", 0),
            obj.get("index", -1),
            bytes.fromhex(obj.get("key", "")),
            bytes.fromhex(obj.get("value", "")),
            bytes.fromhex(obj.get("proof", "")),
            obj.get("height", 0),
            obj.get("log", ""),
        )


@dataclass
class ResponseEndBlock:
    diffs: list[ABCIValidator] = field(default_factory=list)

    def to_json(self):
        return {"diffs": [d.to_json() for d in self.diffs]}

    @classmethod
    def from_json(cls, obj):
        return cls([ABCIValidator.from_json(d) for d in obj.get("diffs", [])])


class Application:
    """The interface ABCI apps implement (abci BaseApplication).
    All methods are synchronous; the local client adds the mutex, the
    socket server adds the wire."""

    def info(self) -> ResponseInfo:
        return ResponseInfo()

    def set_option(self, key: str, value: str) -> str:
        return ""

    def query(self, data: bytes, path: str = "", height: int = 0, prove: bool = False) -> ResponseQuery:
        if prove:
            return proofs_unsupported_response(self, data)
        return ResponseQuery()

    def check_tx(self, tx: bytes) -> ResponseCheckTx:
        return ResponseCheckTx()

    def init_chain(self, validators: list[ABCIValidator]) -> None:
        pass

    def begin_block(self, block_hash: bytes, header: Header) -> None:
        pass

    def deliver_tx(self, tx: bytes) -> ResponseDeliverTx:
        return ResponseDeliverTx()

    def end_block(self, height: int) -> ResponseEndBlock:
        return ResponseEndBlock()

    def commit(self) -> ResponseCommit:
        return ResponseCommit()

    # -- state-sync snapshot hooks (beyond the v0.5 ABCI surface: the
    # reference era predates statesync; these mirror the later
    # ListSnapshots/ApplySnapshotChunk shape at whole-state granularity) --

    def snapshot(self) -> bytes | None:
        """Deterministic byte serialization of the app's COMMITTED state
        at its current height, or None when the app does not support
        snapshots (the statesync producer then skips it). Must be a pure
        read: called synchronously between Commit and the next
        BeginBlock."""
        return None

    def restore(
        self, data: bytes, height: int | None = None, app_hash: bytes | None = None
    ) -> None:
        """Replace the app's state wholesale with a snapshot()'s bytes.
        Only valid on a fresh app (height 0). `height`/`app_hash`, when
        given, are the LIGHT-VERIFIED values the snapshot must land on —
        the app MUST validate `data` against them (and against its own
        internal consistency, e.g. recomputing the app hash from the
        restored state) and raise ValueError BEFORE mutating or
        persisting anything: `data` is attacker input until it checks
        out. The restorer re-checks the resulting Info() as a final
        gate, but by then a badly-written app has already applied."""
        raise NotImplementedError(f"{type(self).__name__} cannot restore snapshots")
