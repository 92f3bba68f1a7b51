"""String-keyed pub/sub event bus (reference: tmlibs/events EventSwitch +
EventCache; usage at types/events.go:160-186, consensus/state.go:1316).

The consensus state machine fires events (NewBlock, Vote, NewRoundStep, ...);
the consensus reactor and the RPC WebSocket manager subscribe. An EventCache
buffers events fired during block execution and flushes them after commit.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from tendermint_tpu_torch.libs.service import BaseService

EventCallback = Callable[[Any], None]


class Fireable:
    def fire_event(self, event: str, data: Any) -> None:  # pragma: no cover
        raise NotImplementedError


class EventSwitch(BaseService, Fireable):
    """Listener registry keyed by (event string, listener id)."""

    def __init__(self):
        super().__init__("EventSwitch")
        self._mtx = threading.RLock()
        # event -> {listener_id -> callback}
        self._cells: dict[str, dict[str, EventCallback]] = {}
        # listener_id -> set of events (for remove_listener)
        self._listeners: dict[str, set[str]] = {}

    def add_listener_for_event(self, listener_id: str, event: str, cb: EventCallback) -> None:
        with self._mtx:
            self._cells.setdefault(event, {})[listener_id] = cb
            self._listeners.setdefault(listener_id, set()).add(event)

    def remove_listener_for_event(self, event: str, listener_id: str) -> None:
        with self._mtx:
            cell = self._cells.get(event)
            if cell:
                cell.pop(listener_id, None)
                if not cell:
                    del self._cells[event]
            evs = self._listeners.get(listener_id)
            if evs:
                evs.discard(event)
                if not evs:
                    del self._listeners[listener_id]

    def remove_listener(self, listener_id: str) -> None:
        with self._mtx:
            for event in self._listeners.pop(listener_id, set()):
                cell = self._cells.get(event)
                if cell:
                    cell.pop(listener_id, None)
                    if not cell:
                        del self._cells[event]

    def fire_event(self, event: str, data: Any) -> None:
        with self._mtx:
            cbs = list(self._cells.get(event, {}).values())
        for cb in cbs:
            cb(data)


class EventCache(Fireable):
    """Buffers events; flush() fires them on the underlying switch in order.

    Used during finalizeCommit so subscribers observe a block's events only
    after the block is fully committed (consensus/state.go:1316,1338)."""

    def __init__(self, evsw: Fireable):
        self._evsw = evsw
        self._pending: list[tuple[str, Any]] = []

    def fire_event(self, event: str, data: Any) -> None:
        self._pending.append((event, data))

    def flush(self) -> None:
        pending, self._pending = self._pending, []
        for event, data in pending:
            self._evsw.fire_event(event, data)
