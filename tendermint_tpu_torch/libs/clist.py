"""Concurrent ordered list with blocking iteration (reference: tmlibs/clist,
used by the mempool to hold good txs and by the mempool reactor's per-peer
broadcast routine which blocks on FrontWait/NextWait —
mempool/mempool.go:61, mempool/reactor.go:114-152).

Elements stay navigable after removal: a detached element's next pointers
keep working so an iterator parked on a removed element can continue.
"""

from __future__ import annotations

import threading
from typing import Any


class CElement:
    __slots__ = ("value", "_next", "_prev", "_removed", "_list", "_next_wake")

    def __init__(self, value: Any, lst: "CList"):
        self.value = value
        self._next: CElement | None = None
        self._prev: CElement | None = None
        self._removed = False
        self._list = lst
        # lazily allocated on first next_wait: a 50k-tx CheckTx burst
        # builds 50k elements but parks iterators on only a handful, and
        # Condition construction dominated the burst profile (~20%)
        self._next_wake: threading.Condition | None = None

    def next(self) -> "CElement | None":
        with self._list._mtx:
            return self._next

    def next_wait(self, timeout: float | None = None) -> "CElement | None":
        """Block until this element has a next, or it is removed (then None
        means the iterator should restart from front), or timeout."""
        with self._list._mtx:
            if self._next is None and not self._removed:
                if self._next_wake is None:
                    self._next_wake = threading.Condition(self._list._mtx)
                self._next_wake.wait(timeout)
            return self._next

    @property
    def removed(self) -> bool:
        with self._list._mtx:
            return self._removed


class CList:
    def __init__(self):
        self._mtx = threading.RLock()
        self._head: CElement | None = None
        self._tail: CElement | None = None
        self._len = 0
        self._front_wake = threading.Condition(self._mtx)

    def __len__(self) -> int:
        with self._mtx:
            return self._len

    def front(self) -> CElement | None:
        with self._mtx:
            return self._head

    def front_wait(self, timeout: float | None = None) -> CElement | None:
        with self._mtx:
            if self._head is None:
                self._front_wake.wait(timeout)
            return self._head

    def back(self) -> CElement | None:
        with self._mtx:
            return self._tail

    def push_back(self, value: Any) -> CElement:
        with self._mtx:
            el = CElement(value, self)
            el._prev = self._tail
            if self._tail is not None:
                self._tail._next = el
                if self._tail._next_wake is not None:
                    self._tail._next_wake.notify_all()
            else:
                self._head = el
                self._front_wake.notify_all()
            self._tail = el
            self._len += 1
            return el

    def remove(self, el: CElement) -> Any:
        with self._mtx:
            if el._removed:
                return el.value
            prev, nxt = el._prev, el._next
            if prev is not None:
                prev._next = nxt
            else:
                self._head = nxt
            if nxt is not None:
                nxt._prev = prev
            else:
                self._tail = prev
            el._removed = True
            self._len -= 1
            # wake any iterator blocked in next_wait on the removed element
            if el._next_wake is not None:
                el._next_wake.notify_all()
            return el.value

    def __iter__(self):
        el = self.front()
        while el is not None:
            yield el
            el = el.next()
