"""TimeoutTicker: the consensus timer (reference: consensus/ticker.go).

One background thread owns a single pending timeout. schedule_timeout
replaces it iff the new (H,R,S) is not older than the pending one
(consensus/ticker.go:94-131: stale ticks ignored, newer ticks overwrite).
Fired timeouts land on `chan`, consumed by the receive routine.

MockTicker is the test seam (consensus/common_test.go:426-470): it fires
only on NewHeight timeouts, immediately, so tests single-step the state
machine by injecting votes rather than waiting on wall clocks.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

from tendermint_tpu_torch.consensus.round_state import RoundStep
from tendermint_tpu_torch.libs.service import BaseService


@dataclass(frozen=True)
class TimeoutInfo:
    duration: float  # seconds
    height: int
    round_: int
    step: int

    def hrs(self) -> tuple[int, int, int]:
        return (self.height, self.round_, self.step)

    def to_json(self):
        return {
            "duration": self.duration,
            "height": self.height,
            "round": self.round_,
            "step": self.step,
        }

    @classmethod
    def from_json(cls, o):
        return cls(o["duration"], o["height"], o["round"], o["step"])


class TickerI:
    def start(self) -> bool:
        raise NotImplementedError

    def stop(self) -> bool:
        raise NotImplementedError

    @property
    def chan(self) -> "queue.Queue[TimeoutInfo]":
        raise NotImplementedError

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        raise NotImplementedError


class TimeoutTicker(BaseService, TickerI):
    def __init__(self):
        BaseService.__init__(self, "TimeoutTicker")
        self._chan: queue.Queue[TimeoutInfo] = queue.Queue(maxsize=10)
        self._tick: queue.Queue[TimeoutInfo] = queue.Queue()
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()

    @property
    def chan(self):
        return self._chan

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        self._tick.put(ti)

    def on_start(self) -> None:
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._timeout_routine, daemon=True, name="TimeoutTicker")
        self._thread.start()

    def on_stop(self) -> None:
        self._stop_evt.set()
        self._tick.put(None)  # wake the routine
        if self._thread:
            self._thread.join(timeout=2)

    def _timeout_routine(self) -> None:
        pending: TimeoutInfo | None = None
        deadline = 0.0
        import time

        while not self._stop_evt.is_set():
            if pending is None:
                ti = self._tick.get()
                if ti is None:
                    continue
                pending, deadline = ti, time.monotonic() + ti.duration
                continue
            wait = deadline - time.monotonic()
            if wait <= 0:
                self._chan.put(pending)
                pending = None
                continue
            try:
                ti = self._tick.get(timeout=wait)
            except queue.Empty:
                continue  # deadline check on next loop
            if ti is None:
                continue
            # newer (or equal-H/R, later-step) tick replaces; stale ignored
            if ti.hrs() >= pending.hrs():
                pending, deadline = ti, time.monotonic() + ti.duration
            else:
                self.logger.debug("ignoring stale tick %s < %s", ti, pending)


class MockTicker(TickerI):
    """Fires only NewHeight timeouts, synchronously on schedule
    (consensus/common_test.go:426-470). Everything else is driven by
    injected votes in tests."""

    def __init__(self):
        self._chan: queue.Queue[TimeoutInfo] = queue.Queue(maxsize=10)
        self._only_once = False
        self._fired = False
        self._mtx = threading.Lock()

    @property
    def chan(self):
        return self._chan

    def start(self) -> bool:
        return True

    def stop(self) -> bool:
        return True

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        with self._mtx:
            if self._only_once and self._fired:
                return
            if ti.step == RoundStep.NEW_HEIGHT:
                self._chan.put(ti)
                self._fired = True
