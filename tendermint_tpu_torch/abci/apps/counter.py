"""Counter app — txs must arrive in strict serial order when serial mode is
on; used by the mempool-vs-commit concurrency tests
(consensus/mempool_test.go in the reference)."""

from __future__ import annotations

import struct

from tendermint_tpu_torch.abci.types import (
    Application,
    CODE_BAD_NONCE,
    CODE_OK,
    ResponseCheckTx,
    ResponseCommit,
    ResponseDeliverTx,
    ResponseInfo,
    ResponseQuery,
)


def _tx_value(tx: bytes) -> int:
    """Big-endian integer, up to 8 bytes."""
    if len(tx) > 8:
        raise ValueError("tx too long")
    return int.from_bytes(tx, "big")


class CounterApp(Application):
    def __init__(self, serial: bool = False):
        self.serial = serial
        self.tx_count = 0
        self.check_count = 0

    def info(self) -> ResponseInfo:
        return ResponseInfo(data=f"{{\"hashes\":{self.tx_count},\"txs\":{self.tx_count}}}")

    def set_option(self, key: str, value: str) -> str:
        if key == "serial" and value == "on":
            self.serial = True
            return "ok"
        return ""

    def check_tx(self, tx: bytes) -> ResponseCheckTx:
        if self.serial:
            try:
                value = _tx_value(tx)
            except ValueError:
                return ResponseCheckTx(code=CODE_BAD_NONCE, log="tx too long")
            if value < self.check_count:
                return ResponseCheckTx(
                    code=CODE_BAD_NONCE,
                    log=f"invalid nonce: got {value}, expected >= {self.check_count}",
                )
            self.check_count += 1
        return ResponseCheckTx(code=CODE_OK)

    def deliver_tx(self, tx: bytes) -> ResponseDeliverTx:
        if self.serial:
            try:
                value = _tx_value(tx)
            except ValueError:
                return ResponseDeliverTx(code=CODE_BAD_NONCE, log="tx too long")
            if value != self.tx_count:
                return ResponseDeliverTx(
                    code=CODE_BAD_NONCE,
                    log=f"invalid nonce: got {value}, expected {self.tx_count}",
                )
        self.tx_count += 1
        return ResponseDeliverTx(code=CODE_OK)

    def commit(self) -> ResponseCommit:
        self.check_count = self.tx_count
        if self.tx_count == 0:
            return ResponseCommit(code=CODE_OK, data=b"")
        return ResponseCommit(code=CODE_OK, data=struct.pack(">Q", self.tx_count))

    def query(self, data: bytes, path: str = "", height: int = 0, prove: bool = False) -> ResponseQuery:
        if prove:
            from tendermint_tpu_torch.abci.types import proofs_unsupported_response

            return proofs_unsupported_response(self, data)
        if path == "hash" or data == b"hash":
            return ResponseQuery(code=CODE_OK, value=str(self.tx_count).encode())
        if path == "tx" or data == b"tx":
            return ResponseQuery(code=CODE_OK, value=str(self.tx_count).encode())
        return ResponseQuery(code=CODE_OK, log=f"unexpected query path {path}")
