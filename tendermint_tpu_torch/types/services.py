"""Abstract service interfaces shared across layers, with mocks for tests
(reference: types/services.go)."""

from __future__ import annotations

from typing import Callable


class MempoolI:
    """types/services.go:21-35."""

    def lock(self) -> None:
        raise NotImplementedError

    def unlock(self) -> None:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def check_tx(self, tx: bytes, cb: Callable | None = None):
        raise NotImplementedError

    def reap(self, max_txs: int) -> list[bytes]:
        raise NotImplementedError

    def update(self, height: int, txs: list[bytes]) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def enable_txs_available(self, cb: Callable | None = None) -> None:
        """cb() fires (at most once per height) when the pool goes
        non-empty — the no-empty-blocks signal."""
        raise NotImplementedError


class MockMempool(MempoolI):
    """No-op mempool (types/services.go:37-48) — used by replay and tests."""

    def lock(self) -> None:
        pass

    def unlock(self) -> None:
        pass

    def size(self) -> int:
        return 0

    def check_tx(self, tx: bytes, cb: Callable | None = None):
        return None

    def reap(self, max_txs: int) -> list[bytes]:
        return []

    def update(self, height: int, txs: list[bytes]) -> None:
        pass

    def flush(self) -> None:
        pass

    def enable_txs_available(self, cb: Callable | None = None) -> None:
        pass


class BlockStoreRPC:
    """Read surface (types/services.go:55-64)."""

    def height(self) -> int:
        raise NotImplementedError

    def base(self) -> int:
        """Lowest servable height (>1 after prune/restore)."""
        raise NotImplementedError

    def load_block_meta(self, height: int):
        raise NotImplementedError

    def load_block(self, height: int):
        raise NotImplementedError

    def load_block_part(self, height: int, index: int):
        raise NotImplementedError

    def load_block_commit(self, height: int):
        raise NotImplementedError

    def load_seen_commit(self, height: int):
        raise NotImplementedError


class BlockStoreI(BlockStoreRPC):
    """Full store (types/services.go:66-71)."""

    def save_block(self, block, part_set, seen_commit) -> None:
        raise NotImplementedError
